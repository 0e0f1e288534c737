"""Run every solver family on the 64^3 Poisson problem and print a table.

The CubeZ acceptance ritual: each solver's iteration count, final residual,
analytic max error, and throughput (Readme.md:384-403 invocations).

    python examples/run_all_solvers.py

Runs on JAX's default device (the GPU where there is one); set
JAX_PLATFORMS=cpu to run on the CPU.
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

from cubez_tpu import Problem, max_error, solve

N = 64
ITMAX = 20000
# documented omegas (Readme.md:386-391, main.cpp:24-27); pcr is the serial
# reference's line-Gauss-Seidel (stable at 1.5, wavefront-exact but slow);
# pcr_j_esa is the Jacobi-update form and needs omega ~1
CONFIGS = [
    ("jacobi", 0.8, None),
    ("sor2sma", 1.5, None),
    ("pcr_rb", 1.5, None),
    ("pcr_j_esa", 1.0, None),
    ("pbicgstab", 1.1, "sor2sma"),
    ("jacobi_maf", 0.8, None),
    ("sor2sma_maf", 1.5, None),
    ("pcr_rb_maf", 1.5, None),
    ("pbicgstab_maf", 1.1, "sor2sma_maf"),
    # extensions beyond the reference (README "Beyond the reference")
    ("mg", 1.0, None),
    ("mg_maf", 1.0, None),
    ("fmg", 1.0, None),
    ("fmg_maf", 1.0, None),
    ("fd", 1.0, None),
    ("fd_maf", 1.0, None),
    ("pbicgstab", 1.1, "fd"),
    ("pbicgstab", 1.1, "mg"),
    ("pbicgstab_maf", 1.1, "mg_maf"),
    ("cg", 0.8, None),
    ("cg", 0.8, "jacobi"),
]


def main():
    print(f"{'solver':<22}{'omega':>6}{'iters':>8}{'residual':>12}"
          f"{'err_max':>12}{'Mcells/s':>10}")
    for name, om, precond in CONFIGS:
        maf = name.endswith("_maf")
        prob = Problem.poisson_cube(N, dtype=jnp.float32, maf=maf)
        t0 = time.perf_counter()
        r = solve(prob, name, omega=om, itr_max=ITMAX, precond=precond)
        jax.block_until_ready(r.x)
        dt = time.perf_counter() - t0
        err = max_error(prob.grid, r.x)
        cups = prob.grid.num_inner * r.iters / dt / 1e6
        label = f"{name}+{precond}" if precond else name
        print(f"{label:<22}{om:>6}{r.iters:>8}{r.res:>12.3e}{err:>12.3e}"
              f"{cups:>10.1f}")

    # psor and pcr are exact wavefront Gauss-Seidel (point / line): O(N)
    # sequential masked passes per iteration, so demo them small (their math
    # and reference parity are covered in tests/test_ref_parity.py)
    for name, om in (("psor", 1.1), ("pcr", 1.5)):
        prob = Problem.poisson_cube(24, dtype=jnp.float32)
        t0 = time.perf_counter()
        r = solve(prob, name, omega=om, itr_max=2000)
        jax.block_until_ready(r.x)
        dt = time.perf_counter() - t0
        err = max_error(prob.grid, r.x)
        print(f"{name + ' (24^3)':<22}{om:>6}{r.iters:>8}{r.res:>12.3e}"
              f"{err:>12.3e}{prob.grid.num_inner * r.iters / dt / 1e6:>10.1f}")


if __name__ == "__main__":
    main()
