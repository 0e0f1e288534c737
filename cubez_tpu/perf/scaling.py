"""Weak/strong-scaling harness over the device mesh.

The reference documents multi-node runs only as mpirun invocations
(example/scripts.txt); this module makes scaling a first-class measurement:
run the same per-device block size over growing meshes and report parallel
efficiency.  On a single host it exercises the real collective code paths
over XLA's virtual CPU devices (functional check); on several GPUs the same
code measures the explicit shard_map steps over NVLink.
"""

from __future__ import annotations

import dataclasses
import time

import jax

from ..core.problem import Problem
from ..parallel.dist import make_dist_step
from ..parallel.mesh import make_mesh


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    div: tuple
    global_shape: tuple
    iters: int
    seconds: float

    @property
    def cells_per_s(self) -> float:
        nk, ni, nj = self.global_shape
        inner = (nk - 2) * (ni - 2) * (nj - 2)
        return inner * self.iters / self.seconds


def weak_scaling(
    block: int = 64,
    solver: str = "sor2sma",
    omega: float = 1.5,
    iters: int = 50,
    device_counts=None,
) -> list[ScalePoint]:
    """Fixed per-device block, growing mesh; returns one point per count.
    Each point times ``iters`` iterations of the explicit shard_map step
    (parallel/dist.py)."""
    from ..parallel.decomp import auto_division
    from ..solvers.steps import parse_name

    devices = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    _, is_maf = parse_name(solver)
    points = []
    for n in device_counts:
        # grow the cube so each device holds a block^3 region
        div = auto_division(n, (10**9, 10**9, 10**9))
        gsize = tuple(block * d for d in div)
        cm = make_mesh(gsize, devices=devices[:n], div=div)
        prob = Problem.poisson_cube((gsize[1], gsize[2], gsize[0]), maf=is_maf)
        step = make_dist_step(prob, cm, solver, omega)
        x = cm.shard(prob.x0)
        b = cm.shard(prob.rhs)

        def run(x, b):
            def body(_, xx):
                xx, _r = step(xx, b)
                return xx

            return jax.lax.fori_loop(0, iters, body, x)

        runj = jax.jit(run)
        y = runj(x, b)
        jax.block_until_ready(y)
        t0 = time.perf_counter()
        y = runj(y, b)
        jax.block_until_ready(y)
        dt = time.perf_counter() - t0
        points.append(
            ScalePoint(
                n_devices=n, div=div, global_shape=gsize, iters=iters,
                seconds=dt,
            )
        )
    return points


def efficiency(points: list[ScalePoint]) -> list[float]:
    """Weak-scaling efficiency vs the 1-device point (1.0 = perfect)."""
    if not points:
        return []
    base = points[0].cells_per_s / points[0].n_devices
    return [p.cells_per_s / p.n_devices / base for p in points]


def report(points: list[ScalePoint]) -> str:
    eff = efficiency(points)
    lines = [f"{'devs':>5} {'mesh':>10} {'grid':>16} {'Mcells/s':>10} {'eff':>6}"]
    for p, e in zip(points, eff):
        lines.append(
            f"{p.n_devices:>5} {str(p.div):>10} {str(p.global_shape):>16} "
            f"{p.cells_per_s / 1e6:>10.1f} {e:>6.2f}"
        )
    return "\n".join(lines)
