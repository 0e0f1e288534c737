"""Preconditioned BiCGSTAB (CZ::PBiCGSTAB, cz_Poisson.cpp:332-504).

The whole Krylov loop runs on-device in one ``lax.while_loop``; dot products
lower to tree reductions (and to psum all-reduces under sharding, the analog
of Fdot1/Fdot2 + Comm_SUM_1, cz_Poisson.cpp:239-270).

The preconditioner is a fixed 8 sweeps of the selected inner solver with no
convergence check (lc_max = 8, cz_Poisson.cpp:280); "none" copies b
(cz_Poisson.cpp:320).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.problem import Problem
from ..ops import blas
from ..ops import maf as maf_ops
from . import steps as steps_mod
from .driver import SolveResult, _res_dtype, fixed_sweeps

FLT_MIN = float(np.finfo(np.float32).tiny)  # rho breakdown (cz_Poisson.cpp:379)
PRECOND_SWEEPS = 8


def make_bicgstab(
    problem: Problem, name: str, omega_accel: float, precond: str | None
):
    """Returns run(x0, b, itr_max, eps) -> (x, itr, res, hist).

    On sharded fields the blas ops and the preconditioner's jnp sweeps
    run auto-SPMD (dots lower to psum all-reduces)."""
    _, is_maf = steps_mod.parse_name(name)
    msk = problem.msk
    mc, pvt = problem.mc, problem.pvt

    if is_maf:
        ax = lambda p: maf_ops.calc_ax_maf(p, msk, mc, pvt)
        rk = lambda p, b: maf_ops.calc_rk_maf(p, b, msk, mc, pvt)
    else:
        ax = lambda p: blas.calc_ax(p, msk)
        rk = lambda p, b: blas.calc_rk(p, b, msk)

    if precond and precond.lower() not in ("none", "copy"):
        # one V-cycle is the canonical multigrid preconditioner (extension;
        # the reference's fixed-8 rule applies to its single-level sweeps).
        # "fmg" as a preconditioner means the same thing: the F-cycle is a
        # solve-level INITIALIZER (and is affine in b through its BC
        # shells — not a linear operator), so it maps to one V-cycle too.
        # "fd" (exact fast-diagonalization inverse) is likewise one
        # application.  All three run at the smoothing omega = 1.0.
        p_is_mg = steps_mod.parse_name(precond)[0] in ("mg", "fmg", "fd")
        if p_is_mg:
            precond = precond.replace("fmg", "mg")
        nsw = 1 if p_is_mg else PRECOND_SWEEPS
        pstep = steps_mod.make_step(
            problem, precond, 1.0 if p_is_mg else omega_accel
        )
        precon = lambda bb: fixed_sweeps(pstep, jnp.zeros_like(bb), bb, nsw)
    else:
        precon = lambda bb: bb  # default: copy (cz_Poisson.cpp:320)

    dot1 = lambda v: blas.dot1(v, msk)
    dot2 = lambda v, w: blas.dot2(v, w, msk)

    @partial(jax.jit, static_argnames=("itr_max",))
    def run(x0, b, itr_max: int, eps: float, res_normal: float):
        rdt = _res_dtype()
        dt = x0.dtype
        hist0 = jnp.zeros((itr_max,), rdt)

        r = rk(x0, b)
        r0 = r
        q = jnp.zeros_like(x0)
        p = jnp.zeros_like(x0)

        def cond(st):
            (x, r, p, q, itr, res, rho_old, alpha, omega, hist, stop) = st
            return jnp.logical_and(
                itr < itr_max,
                jnp.logical_and(
                    jnp.logical_not(stop), jnp.logical_or(itr == 0, res >= eps)
                ),
            )

        def body(st):
            (x, r, p, q, itr, res, rho_old, alpha, omega, hist, stop) = st
            rho = dot2(r, r0)
            breakdown = jnp.abs(rho) < FLT_MIN

            def advance(op):
                x, r, p, q, itr, res, alpha, omega, hist = op
                beta = rho / rho_old * alpha / omega
                p = jnp.where(
                    itr == 0, r, blas.bicg_1(p, r, q, beta, omega, msk)
                )
                p_ = precon(p)
                q = ax(p_)
                den_q = dot2(q, r0)
                alpha = rho / jnp.where(jnp.abs(den_q) < FLT_MIN, 1.0, den_q)
                s = blas.triad(q, r, -alpha, msk)
                s_ = precon(s)
                t_ = ax(s_)
                den_t = dot1(t_)
                omega = dot2(t_, s) / jnp.where(den_t < FLT_MIN, 1.0, den_t)
                x = blas.bicg_2(x, p_, s_, alpha, omega, msk)
                r = blas.triad(t_, s, -omega, msk)

                res2 = dot1(r)
                res = jnp.sqrt(res2.astype(rdt) * jnp.asarray(res_normal, rdt))
                hist = jax.lax.dynamic_update_index_in_dim(hist, res, itr, 0)
                return (x, r, p, q, itr + 1, res, alpha, omega, hist)

            # |rho| < FLT_MIN breaks BEFORE the iteration touches any state
            # (cz_Poisson.cpp:379-383: itr = 0; break) — the whole update is
            # inside the cond so x is provably untouched on breakdown.
            op = (x, r, p, q, itr, res, alpha, omega, hist)
            x, r, p, q, itr, res, alpha, omega, hist = jax.lax.cond(
                breakdown, lambda op: op, advance, op
            )
            return (x, r, p, q, itr, res, rho, alpha, omega, hist, breakdown)

        one = jnp.ones((), dt)
        st0 = (
            x0,
            r,
            p,
            q,
            jnp.int32(0),
            jnp.asarray(jnp.inf, rdt),
            one,  # rho_old = 1 (cz_Poisson.cpp:368)
            jnp.zeros((), dt),  # alpha = 0
            one,  # omega = 1
            hist0,
            jnp.bool_(False),
        )
        x, r, p, q, itr, res, *_rest, hist, stop = jax.lax.while_loop(
            cond, body, st0
        )
        return x, itr, res, hist, stop

    def solve(x0, b, itr_max: int, eps: float, res_normal: float) -> SolveResult:
        # reference loops itr = 1 .. ItrMax-1 (cz_Poisson.cpp:373)
        x, itr, res, hist, stop = run(
            x0, b, max(int(itr_max) - 1, 1), float(eps), float(res_normal)
        )
        # one batched host transfer for the scalars
        done, stop_v, res_v = jax.device_get((itr, stop, res))
        done = int(done)  # iterations that completed (wrote a history row)
        # rho breakdown reports itr = 0 like the reference (cz_Poisson.cpp:381)
        iters = 0 if bool(stop_v) else done
        return SolveResult(
            x=x, iters=iters, res=float(res_v), history=hist[:done]
        )

    return solve
