"""Measured per-phase profiling of solver runs — the PMlib report with real
section timings (PM.start/stop around every kernel and comm call,
cz.h:506-539, report cz_Evaluate.cpp:506-544).

Under jit a solve is one fused executable, so phases are measured by timing
dedicated sub-executables (sweep-only, halo-refresh-only) over a fixed
iteration count and attributing analytic flop/byte costs (the reference
accumulates flops analytically inside each kernel too,
cz_solver.f90:238-241).  COMM bytes use the reference's accounting:
2 (send+recv) x 2 (both directions) x face area x itemsize per axis per
exchange (cz_Evaluate.cpp:181-184).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from .pmlib import CALC, COMM, PerfMonitor, device_peaks
from .roofline import sweep_cost


def _timed(fn, *args, reps: int = 3):
    """Median wall time of fn(*args) with completion forced."""
    out = fn(*args)
    jax.block_until_ready(out)  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def comm_bytes_per_exchange(block_shape, itemsize: int) -> int:
    """CBrick width-1 6-face halo volume per exchange per device
    (comm_size = 2*2*(xy+yz+xz)*sizeof, cz_Evaluate.cpp:181-184)."""
    lk, li, lj = block_shape
    return 2 * 2 * (lk * li + li * lj + lj * lk) * itemsize


def profile_solve(problem, solver: str, omega: float, iters: int = 50,
                  cmesh=None, impl: str = "auto") -> PerfMonitor:
    """Measure per-phase sections for ``iters`` iterations of ``solver``.

    Serial: sweep kernel vs driver overhead.  Distributed (cmesh given):
    halo exchange (COMM, with bytes), block sweep (CALC), residual
    allreduce (COMM) — measured by timing sub-executables.
    """
    from ..solvers.driver import fixed_sweeps

    g = problem.grid
    itemsize = jnp.dtype(g.dtype).itemsize
    peaks = device_peaks()
    pm = PerfMonitor(hbm_gbps=peaks and peaks["hbm_gbps"])
    kind = solver.lower()
    base = kind[:-4] if kind.endswith("_maf") else kind
    flops1, bytes1 = sweep_cost(base, g.shape_kij, itemsize)

    from ..solvers.steps import parse_name

    k, is_maf = parse_name(solver)

    if cmesh is None:
        from ..solvers import dispatch
        from ..solvers.fused_cache import get_jnp_step, get_rb_step

        # the same choice solve() makes (solvers/dispatch.py)
        if dispatch.use_rb_kernel(
            k, g.dtype, impl=impl,
            sharded=dispatch.is_sharded(problem.x0),
            standard_mask=problem.msk_is_standard(),
        ):
            step = get_rb_step(problem, solver, omega)
            x, b = step._pre(problem.x0), step._pre(problem.rhs)
        else:
            step = get_jnp_step(problem, solver, omega)
            x, b = problem.x0, problem.rhs
        run = jax.jit(lambda x, b: fixed_sweeps(step, x, b, iters))
        t_sweeps = _timed(run, x, b)
        pm.add(f"{solver}_sweep", t_sweeps, kind=CALC,
               flops=flops1 * iters, bytes=bytes1 * iters, calls=iters)

        from ..solvers.driver import run_iterative

        t0 = time.perf_counter()
        r = run_iterative(step, x, b, g.res_normal, iters, eps=0.0)
        jax.block_until_ready(r.x)
        t_loop = time.perf_counter() - t0
        pm.add("driver_overhead", max(t_loop - t_sweeps, 0.0), kind=CALC,
               calls=iters)
        return pm

    # ---- distributed ------------------------------------------------------
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.dist import make_dist_step
    from ..parallel.halo import exchange_halo
    from ..parallel.mesh import AXES, FIELD_SPEC

    dz, dx, dy = cmesh.div
    bs = (g.nk // dz, g.ni // dx, g.nj // dy)
    cbytes = comm_bytes_per_exchange(bs, itemsize)

    step = make_dist_step(problem, cmesh, solver, omega)
    x = cmesh.shard(problem.x0)
    b = cmesh.shard(problem.rhs)
    refresh = shard_map(
        lambda xb: exchange_halo(xb)[1:-1, 1:-1, 1:-1],
        mesh=cmesh.mesh, in_specs=(FIELD_SPEC,), out_specs=FIELD_SPEC,
    )

    run = jax.jit(lambda x, b: fixed_sweeps(step, x, b, iters))
    t_step = _timed(run, x, b)

    refresh_n = jax.jit(
        lambda x: jax.lax.fori_loop(0, iters, lambda _, xx: refresh(xx), x)
    )
    t_halo = _timed(refresh_n, x)

    psum_n = shard_map(
        lambda v: jax.lax.fori_loop(
            0, iters, lambda _, a: jax.lax.psum(a * 0.5, AXES), v
        ),
        mesh=cmesh.mesh, in_specs=(P(),), out_specs=P(),
    )
    t_psum = _timed(jax.jit(psum_n), jnp.ones(()))

    n_exch = 2 if k in ("sor2sma", "pcr_rb") else 1  # per-color refresh
    pm.add("halo_exchange", t_halo * n_exch, kind=COMM,
           bytes=cbytes * iters * n_exch, calls=iters * n_exch)
    pm.add("residual_allreduce", t_psum, kind=COMM,
           bytes=4 * 2 * iters, calls=iters)
    pm.add(f"{kind}_block_sweep",
           max(t_step - t_halo * n_exch - t_psum, 0.0), kind=CALC,
           flops=flops1 * iters, bytes=bytes1 * iters, calls=iters)
    return pm
