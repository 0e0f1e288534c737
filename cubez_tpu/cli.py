"""CLI with the reference's exact positional interface (src/main.cpp:19-30):

    python -m cubez_tpu.cli gsz_x gsz_y gsz_z solver ItrMax coef \\
        [precond] [gdv_x gdv_y gdv_z] [--fp64] [--eps E] [--devices N]

Writes `<solver>.txt` residual history (cz_Evaluate.cpp:210-218), prints the
iteration/residual banner (cz_Evaluate.cpp:492-496) and the analytic
``Error max`` check (cz_Evaluate.cpp:550-563).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_argparser():
    ap = argparse.ArgumentParser(
        prog="czx",
        description="CubeZ-capability structured-grid iterative-solver platform",
    )
    ap.add_argument("gsz", nargs=3, type=int, help="global node counts x y z")
    ap.add_argument("solver", type=str)
    ap.add_argument("itr_max", type=int)
    ap.add_argument("coef", type=float, help="acceleration coefficient omega")
    ap.add_argument("rest", nargs="*", help="[precond] [gdv_x gdv_y gdv_z]")
    ap.add_argument("--fp64", action="store_true", help="REAL_IS_DOUBLE build parity")
    ap.add_argument("--eps", type=float, default=1.0e-5)
    ap.add_argument("--dist", action="store_true", help="shard over all devices")
    ap.add_argument(
        "--impl", choices=("auto", "pallas", "jnp"), default="auto",
        help="sweep implementation (auto: the red-black Triton kernel on a "
        "GPU where solvers/dispatch.py picks it, XLA elsewhere)",
    )
    ap.add_argument(
        "--profile", action="store_true",
        help="write profiling.txt (PMlib-style timing/flops/roofline report)",
    )
    ap.add_argument(
        "--dump", metavar="FILE.sph", default=None,
        help="dump the final field in SPH format (fileout_t equivalent)",
    )
    ap.add_argument(
        "--warmup", action="store_true",
        help="compile the exact solve executable first so the reported wall "
        "time excludes compilation",
    )
    ap.add_argument(
        "--platform", choices=("cpu", "gpu"), default=None,
        help="pin the JAX platform in-process",
    )
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from .utils import compile_cache

    compile_cache.enable()
    if args.fp64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from . import Problem, solve
    from .solvers.steps import parse_name

    precond = None
    gdv = None
    rest = list(args.rest)
    if rest and not rest[0].isdigit():
        precond = rest.pop(0)
    if len(rest) == 3:
        gdv = tuple(int(v) for v in rest)
    elif rest:
        print(f"unexpected trailing args: {rest}", file=sys.stderr)
        return 2

    kind, is_maf = parse_name(args.solver)  # validate early
    if kind == "pbicgstab" and precond is None:
        precond = "none"

    gx, gy, gz = args.gsz
    dtype = jnp.float64 if args.fp64 else jnp.float32
    prob = Problem.poisson_cube((gx, gy, gz), dtype=dtype, maf=is_maf)

    cm = None
    if (args.dist or gdv) and args.impl == "pallas":
        # solve() checks --impl on one device; a mesh runs jnp steps only
        print("--impl pallas: there is no distributed kernel", file=sys.stderr)
        return 2
    if args.dist or gdv:
        from .parallel.mesh import make_mesh

        div = (gdv[2], gdv[0], gdv[1]) if gdv else None  # argv order x,y,z -> z,x,y
        cm = make_mesh((gz, gx, gy), div=div)
        print(f"mesh division (z,x,y) = {cm.div}")

    print(f"Iterative Method = {args.solver}")
    if kind == "pbicgstab":
        print(f"Preconditioner = {precond}")

    if args.warmup:
        # same static config, trivially-satisfied eps -> one iteration
        # compiles the exact executable (serial AND distributed)
        if cm is not None:
            from .parallel.api import solve_dist

            solve_dist(
                prob, cm, args.solver, omega=args.coef,
                itr_max=args.itr_max, eps=1e9, precond=precond,
            )
        else:
            solve(
                prob, args.solver, omega=args.coef, itr_max=args.itr_max,
                eps=1e9, precond=precond, impl=args.impl,
            )

    t0 = time.perf_counter()
    if cm is not None:
        from .parallel.api import solve_dist

        res = solve_dist(
            prob, cm, args.solver, omega=args.coef, itr_max=args.itr_max,
            eps=args.eps, history_path=f"{args.solver}.txt", precond=precond,
        )
    else:
        res = solve(
            prob,
            args.solver,
            omega=args.coef,
            itr_max=args.itr_max,
            eps=args.eps,
            precond=precond,
            history_path=f"{args.solver}.txt",
            impl=args.impl,
        )
    jax.block_until_ready(res.x)
    dt = time.perf_counter() - t0

    print("\n=================================")
    print(f"Iter = {res.iters}  Res = {res.res:e}")
    print("=================================")
    cells = prob.grid.num_inner * res.iters
    print(f"wall = {dt:.3f} s   {cells / dt / 1e6:.1f} Mcell-updates/s")

    if args.profile:
        # measured per-phase sections (sweep / halo / allreduce / driver)
        # with analytic flops+bytes — the PMlib report with real timings
        from .perf.pmlib import CALC
        from .perf.profile import profile_solve

        pm = profile_solve(
            prob,
            args.solver
            if kind not in ("pbicgstab", "cg", "mg", "fmg", "fd")
            else "sor2sma",
            omega=args.coef, iters=min(50, max(res.iters, 1)), cmesh=cm,
            impl=args.impl,
        )
        pm.add("solve_total", dt, kind=CALC, calls=res.iters)
        pm.sections["solve_total"].exclusive = False
        pm.write("profiling.txt")
        print("profiling.txt written")

    if args.dump:
        from .utils.native import write_sph

        p = prob.grid.pitch
        write_sph(args.dump, res.x, pitch=(p, p, p), step=res.iters)
        print(f"{args.dump} written")

    if gx == gy == gz:
        from .core.grid import max_error_loc

        err, (ei, ej, ek) = max_error_loc(prob.grid, res.x)
        print(f"\nError max = {err:e} at ({ei} {ej} {ek})\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
