"""Preconditioned Conjugate Gradient (extension beyond the reference).

The reference's Krylov solver is BiCGSTAB (cz_Poisson.cpp:332-504), which
works for any operator but costs two A*x products and two preconditioner
applications per iteration.  The constant-coefficient 7-point operator here
(blas.calc_ax: ap = sum(neighbors) - 6 p, cz_blas.f90:579-644) is symmetric
negative-definite on the inner nodes with Dirichlet boundaries, so CG on the
negated system (-A) x = (-b) applies and halves the per-iteration cost —
one A*x, one preconditioner apply, two dot-allreduces (vs BiCGSTAB's 2/2/5).

Preconditioning: CG theory requires a symmetric positive-definite M.  A
fixed number of damped-Jacobi sweeps from a zero initial guess is a
polynomial in D^-1 A with constant D = 6 I here, hence a symmetric
polynomial in A — admissible.  The red-black / line sweeps are nonsymmetric
operators and are rejected (use pbicgstab for those).  Everything runs
on-device in one lax.while_loop; the dots lower to tree reductions (psum
all-reduces under sharding), exactly like bicgstab.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.problem import Problem
from ..ops import blas
from . import steps as steps_mod
from .bicgstab import FLT_MIN, PRECOND_SWEEPS
from .driver import SolveResult, _res_dtype, fixed_sweeps

# preconditioners that are symmetric for the constant-coefficient operator
# (fd = the exact fast-diagonalization inverse, solvers/direct.py — SPD,
# applied once per iteration)
SYMMETRIC_PRECONDS = ("jacobi", "fd")


def make_cg(problem: Problem, omega_accel: float, precond: str | None):
    """Returns solve(x0, b, itr_max, eps, res_normal) -> SolveResult.

    Constant-coefficient only: the MAF operator is pivot-row-scaled
    (search_pivot, cz_blas.f90:947-1039) and therefore nonsymmetric."""
    if problem.mc is not None:
        raise ValueError(
            "cg supports the constant-coefficient operator only "
            "(the pivot-scaled MAF operator is nonsymmetric); use pbicgstab_maf"
        )
    msk = problem.msk

    if precond and precond.lower() not in ("none", "copy"):
        kind, p_maf = steps_mod.parse_name(precond)
        if p_maf or kind not in SYMMETRIC_PRECONDS:
            raise ValueError(
                f"cg requires a symmetric preconditioner "
                f"({', '.join(SYMMETRIC_PRECONDS)} or none); "
                f"'{precond}' is nonsymmetric — use pbicgstab with it"
            )
        nsw = 1 if kind == "fd" else PRECOND_SWEEPS
        pstep = steps_mod.make_step(problem, precond, omega_accel)
        precon = lambda bb: fixed_sweeps(pstep, jnp.zeros_like(bb), bb, nsw)
        # the sweeps approximate calc_ax^{-1}; they are linear in bb (zero
        # initial guess), so -precon(-r) == precon(r) and the negated-system
        # preconditioner needs no sign plumbing
    else:
        precon = lambda bb: bb

    dot1 = lambda v: blas.dot1(v, msk)
    dot2 = lambda v, w: blas.dot2(v, w, msk)

    @partial(jax.jit, static_argnames=("itr_max",))
    def run(x0, b, itr_max: int, eps: float, res_normal: float):
        rdt = _res_dtype()
        dt = x0.dtype
        hist0 = jnp.zeros((itr_max,), rdt)

        # negated system: Abar = -calc_ax is SPD, rbar = -(b - A x)
        r = -blas.calc_rk(x0, b, msk)
        z = precon(r)
        p = z
        rho = dot2(r, z)

        def cond(st):
            x, r, p, itr, res, rho, hist, stop = st
            return jnp.logical_and(
                itr < itr_max,
                jnp.logical_and(
                    jnp.logical_not(stop), jnp.logical_or(itr == 0, res >= eps)
                ),
            )

        def body(st):
            x, r, p, itr, res, rho, hist, stop = st
            breakdown = jnp.abs(rho) < FLT_MIN

            def advance(op):
                x, r, p, itr, res, hist = op
                q = -blas.calc_ax(p, msk)
                den = dot2(p, q)
                alpha = rho / jnp.where(jnp.abs(den) < FLT_MIN, 1.0, den)
                x = x + jnp.asarray(alpha, dt) * p * msk
                r = blas.triad(q, r, -alpha, msk)
                res2 = dot1(r)
                res = jnp.sqrt(res2.astype(rdt) * jnp.asarray(res_normal, rdt))
                hist = jax.lax.dynamic_update_index_in_dim(hist, res, itr, 0)
                z = precon(r)
                rho_new = dot2(r, z)
                beta = rho_new / rho
                p = blas.triad(p, z, beta, msk)
                return (x, r, p, itr + 1, res, hist, rho_new)

            op = (x, r, p, itr, res, hist)
            x, r, p, itr, res, hist, rho_new = jax.lax.cond(
                breakdown,
                lambda op: op + (rho,),
                advance,
                op,
            )
            return (x, r, p, itr, res, rho_new, hist, breakdown)

        st0 = (
            x0, r, p, jnp.int32(0), jnp.asarray(jnp.inf, rdt), rho,
            hist0, jnp.bool_(False),
        )
        x, r, p, itr, res, rho, hist, stop = jax.lax.while_loop(cond, body, st0)
        return x, itr, res, hist, stop

    def solve(x0, b, itr_max: int, eps: float, res_normal: float) -> SolveResult:
        x, itr, res, hist, stop = run(
            x0, b, max(int(itr_max) - 1, 1), float(eps), float(res_normal)
        )
        done, stop_v, res_v = jax.device_get((itr, stop, res))
        done = int(done)
        iters = 0 if bool(stop_v) else done
        return SolveResult(
            x=x, iters=iters, res=float(res_v), history=hist[:done]
        )

    return solve
