"""Headline timing: the sor2sma 128^3 f32 solve to tolerance on one GPU.

Runs the reference's documented headline configuration
(``./cz 124 124 124 sor2sma 10000 1.5``, Readme.md:384-392, at 128^3)
through ``solve`` with the step solvers/dispatch.py picks, and prints one
JSON line: the median wall time to tolerance of five solves with
compilation excluded, the loop's cell-updates per second, the iteration
count against the oracle's, and the card's name and power limit.  The
field (8.4 MB) sits in the H100's L2, so this is a latency figure, not a
bandwidth one.

It measures only on a GPU: on any other backend, on a wrong iteration
count, or on any error it exits non-zero.  Usage: ``python bench.py``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

N = 128
OMEGA = 1.5
ORACLE = (pathlib.Path(__file__).resolve().parent / "tests" / "ref_histories"
          / "f32_sor2sma_128_w1.5.txt")
REPS = 5


def main() -> int:
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print(f"bench.py measures on a GPU; backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    from cubez_tpu import Problem, solve
    from cubez_tpu.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    oracle_iters = len(ORACLE.read_text().splitlines()) - 1

    prob = Problem.poisson_cube(N, dtype=jnp.float32)
    t0 = time.perf_counter()
    r = solve(prob, "sor2sma", omega=OMEGA, itr_max=10000, eps=1e9)
    jax.block_until_ready(r.x)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        r = solve(prob, "sor2sma", omega=OMEGA, itr_max=10000)
        jax.block_until_ready(r.x)
        times.append(time.perf_counter() - t0)
    if r.iters != oracle_iters:
        print(f"sor2sma {N}^3 took {r.iters} iterations, oracle "
              f"{oracle_iters}", file=sys.stderr)
        return 1
    t = sorted(times)[REPS // 2]
    cups = prob.grid.num_inner * r.iters / t
    print(json.dumps({
        "metric": f"sor2sma {N}^3 f32 solve to 1e-5",
        "seconds": t,
        "compile_seconds": compile_s,
        "cells_per_s": cups,
        "iters": r.iters,
        "oracle_iters": oracle_iters,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
