"""Distributed solver steps: explicit shard_map + halo-exchange versions of
the relaxation and line-PCR sweeps.

Semantics follow the reference's multi-rank behavior:

* one width-1 halo exchange per iteration, after both colors of a red-black
  sweep (cz_Poisson.cpp:194-215 — colors are NOT re-synced in between);
* scalar reductions are mesh-wide psums (Comm_SUM_1, cz_comm.cpp:102-120);
* red-black parity is *global* (ip from the block head, cz_Poisson.cpp:179-186);
* K-lines of the line solvers stay block-local, with the halo values entering
  the local tridiagonal through its ends.  Here that fold is expressed by
  extending each local line with its two ghost rows as identity equations
  (x_ghost = known), which is algebraically the reference's
  ``d(kst) += x(kst-1)/6`` fold (cz_solver.f90:578-579) and keeps the SPMD
  program uniform across blocks.

There is also a zero-code "auto-SPMD" path: the serial solvers in
``cubez_tpu.solvers`` are pure jnp, so running them under jit on arrays with
a NamedSharding makes XLA insert the halo collective-permutes and all-reduces
itself.  The explicit path exists for reference-semantics control (local
lines) and for hand-tuning.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..core.problem import Problem
from ..ops import pcr as pcr_ops
from ..ops import stencil
from ..ops.tdma import num_stage
from .halo import exchange_halo, global_offsets, pad_zeros, psum_all
from .mesh import CubeMesh, FIELD_SPEC


def _global_color_masks(block_shape, dtype):
    """Checkerboard masks from *global* indices (see stencil.color_masks)."""
    k0, i0, j0 = global_offsets(block_shape)
    lk, li, lj = block_shape
    kk = jax.lax.broadcasted_iota(jnp.int32, block_shape, 0) + k0
    ii = jax.lax.broadcasted_iota(jnp.int32, block_shape, 1) + i0
    jj = jax.lax.broadcasted_iota(jnp.int32, block_shape, 2) + j0
    par = (kk + ii + jj + 1) % 2
    return (par == 0).astype(dtype), (par == 1).astype(dtype)


def _global_line_masks(block_shape, dtype):
    """(i+j) parity masks for red-black line sweeps, global indices."""
    _, i0, j0 = global_offsets(block_shape)
    ii = jax.lax.broadcasted_iota(jnp.int32, block_shape, 1) + i0
    jj = jax.lax.broadcasted_iota(jnp.int32, block_shape, 2) + j0
    par = (ii + jj) % 2
    return (par == 0).astype(dtype), (par == 1).astype(dtype)


def _interior(a):
    return a[1:-1, 1:-1, 1:-1]


def _overlap_delta(xb, bh, mh, om, delta_fn):
    """dp for one sweep with the halo exchange OVERLAPPED with interior
    compute (the capability the reference lacks — its loop is strictly
    kernel -> Comm_S -> allreduce, cz_Poisson.cpp:39-79).

    The full-block delta is computed with zero ghosts — correct everywhere
    except the 6 one-cell-thick boundary faces, and data-independent of the
    ppermutes, so XLA's latency-hiding scheduler can run the collectives
    concurrently.  The faces are then recomputed from the true ghosts and
    patched in.  Stencil deltas are pure elementwise ops (no reductions),
    so the result is bitwise identical to the sequential exchange-then-sweep.
    """
    dp = _interior(delta_fn(pad_zeros(xb), bh, mh))
    xh = exchange_halo(xb)  # ppermutes — no dependency on dp above
    for axis in range(3):
        L = dp.shape[axis]
        for lo in (True, False):
            sl = [slice(None)] * 3
            sl[axis] = slice(0, 3) if lo else slice(L - 1, L + 2)
            sub = tuple(sl)
            dface = _interior(delta_fn(xh[sub], bh[sub], mh[sub]))
            tgt = [slice(None)] * 3
            tgt[axis] = slice(0, 1) if lo else slice(L - 1, L)
            dp = dp.at[tuple(tgt)].set(dface)
    return dp


# red-black halo cadences of the explicit steps
SYNCS = ("color", "iter", "overlap")


def _rb_iter(xb, bb, mb, cmasks, delta_fn):
    """One red-black iteration with ONE halo exchange (the reference's
    multi-rank cadence, cz_Poisson.cpp:194-215): both colors update the
    halo'd block, so the second color reads stale ghosts of the first.
    Returns (interior, r2)."""
    xh = exchange_halo(xb)
    bh = pad_zeros(bb)
    r2 = jnp.zeros((), xb.dtype)
    for cm in cmasks:
        dp = delta_fn(xh, bh, pad_zeros(mb * cm))
        xh = xh + dp  # the zero-padded mask keeps the ghosts' dp zero
        r2 = r2 + psum_all(jnp.sum(dp * dp))
    return _interior(xh), r2


def make_dist_step(problem: Problem, cmesh: CubeMesh, name: str, omega: float,
                   sync: str = "color"):
    """Build a sharded step(x, b) -> (x_new, r2) running one iteration with
    explicit halo exchange.  Supported: jacobi, sor2sma, pcr_j_esa, pcr_rb
    (+ MAF forms); other solvers raise NotImplementedError.  ``sync``
    (sor2sma; jacobi takes 'color' and 'overlap'): 'color' exchanges
    before each color, 'iter' once per iteration (_rb_iter), 'overlap'
    computes the interior concurrently with the ghost collectives (const
    form; see _overlap_delta)."""
    kind, is_maf = __parse(name)
    if sync not in SYNCS:
        raise ValueError(f"sync must be one of {SYNCS}, got {sync!r}")
    allowed = {"sor2sma": SYNCS, "jacobi": ("color", "overlap")}
    if sync not in allowed.get(kind, ("color",)) or (
        is_maf and sync == "overlap"
    ):
        raise NotImplementedError(
            f"sync={sync!r} has no explicit distributed step for '{name}'"
        )
    overlap = sync == "overlap"

    g = problem.grid
    dtype = g.dtype
    msk = problem.msk
    om = jnp.asarray(omega, dtype)

    if is_maf:
        return _make_dist_maf_step(problem, cmesh, kind, om, sync)

    def sharded(body):
        return shard_map(
            body,
            mesh=cmesh.mesh,
            in_specs=(FIELD_SPEC, FIELD_SPEC, FIELD_SPEC),
            out_specs=(FIELD_SPEC, P()),
        )

    if kind == "jacobi":

        if overlap:

            def body(xb, bb, mb):
                dp = _overlap_delta(
                    xb, pad_zeros(bb), pad_zeros(mb),
                    om, lambda xh, bh, mh: stencil.jacobi_delta(xh, bh, mh, om),
                )
                return xb + dp, psum_all(jnp.sum(dp * dp))

        else:

            def body(xb, bb, mb):
                xh = exchange_halo(xb)
                dp = _interior(
                    stencil.jacobi_delta(xh, pad_zeros(bb), pad_zeros(mb), om)
                )
                return xb + dp, psum_all(jnp.sum(dp * dp))

        fn = sharded(body)
        return lambda x, b: fn(x, b, msk)

    if kind == "sor2sma":

        def body(xb, bb, mb):
            cm0, cm1 = _global_color_masks(xb.shape, dtype)
            if sync == "iter":
                return _rb_iter(
                    xb, bb, mb, (cm0, cm1),
                    lambda xh, bh, mh: stencil.jacobi_delta(xh, bh, mh, om),
                )
            bh, r2 = pad_zeros(bb), jnp.zeros((), dtype)
            for cm in (cm0, cm1):
                mh = pad_zeros(mb * cm)
                if overlap:
                    dp = _overlap_delta(
                        xb, bh, mh, om,
                        lambda xh, bhh, mhh: stencil.jacobi_delta(
                            xh, bhh, mhh, om
                        ),
                    )
                else:
                    xh = exchange_halo(xb)  # per-color exchange: strictly
                    # MORE synchronized than the reference's one exchange per
                    # iteration (cz_Poisson.cpp:194-215) — serial-equivalent
                    dp = _interior(stencil.jacobi_delta(xh, bh, mh, om))
                xb = xb + dp
                r2 = r2 + psum_all(jnp.sum(dp * dp))
            return xb, r2

        fn = sharded(body)
        return lambda x, b: fn(x, b, msk)

    if kind in ("pcr", "pcr_rb"):
        # block-local K-lines with identity ghost rows
        lk = g.nk // cmesh.div[0]
        pn = num_stage(lk + 2)

        def line_solve(xh, bh, mh):
            # columns: local (li, lj); rows: lk+2 incl. ghost identity rows
            xcol = xh[:, 1:-1, 1:-1]
            mcol = mh[:, 1:-1, 1:-1]
            bcol = bh[:, 1:-1, 1:-1]
            r = jnp.asarray(1.0 / 6.0, dtype)
            trans = (
                xh[:, 2:, 1:-1]
                + xh[:, :-2, 1:-1]
                + xh[:, 1:-1, 2:]
                + xh[:, 1:-1, :-2]
            )
            a = -r * mcol
            c = -r * mcol
            d = ((trans - bcol) * r) * mcol + xcol * (1.0 - mcol)
            return pcr_ops.pcr_reduce_var(a, c, d, pn)

        if kind == "pcr":

            def body(xb, bb, mb):
                xh = exchange_halo(xb)
                sol = line_solve(xh, pad_zeros(bb), pad_zeros(mb))
                dp = (sol[1:-1] - xb) * om * mb
                return xb + dp, psum_all(jnp.sum(dp * dp))

        else:

            def body(xb, bb, mb):
                r2 = jnp.zeros((), dtype)
                lm0, lm1 = _global_line_masks(xb.shape, dtype)
                for lm in (lm0, lm1):
                    xh = exchange_halo(xb)
                    sol = line_solve(xh, pad_zeros(bb), pad_zeros(mb))
                    dp = (sol[1:-1] - xb) * om * mb * lm
                    xb = xb + dp
                    r2 = r2 + psum_all(jnp.sum(dp * dp))
                return xb, r2

        fn = sharded(body)
        return lambda x, b: fn(x, b, msk)

    raise NotImplementedError(f"no explicit distributed step for '{name}'")


def _make_dist_maf_step(problem: Problem, cmesh: CubeMesh, kind: str, om,
                        sync: str = "color"):
    """Sharded MAF (variable-coefficient) sweeps.

    The metric coefficients are separable 1D tables (ops/maf.py); each block
    dynamic-slices its extent (with one halo entry each side, padded with
    ones — the padded entries only reach discarded halo lanes) out of the
    replicated global tables using its mesh coordinates.
    """

    from jax import lax

    from ..ops.maf import MafCoeffs

    if kind not in ("jacobi", "sor2sma", "pcr", "pcr_rb"):
        raise NotImplementedError(
            f"explicit distributed MAF step for '{kind}' — use the auto-SPMD "
            "path (serial solver on sharded arrays)"
        )

    g = problem.grid
    dtype = g.dtype
    msk = problem.msk
    mc = problem.mc

    def pad1(v):
        return jnp.pad(v.reshape(-1), (1, 1), constant_values=1.0)

    # replicated padded global tables, entry p maps to global index p-1
    tabs = tuple(
        pad1(v) for v in (mc.c1, mc.c7, mc.c2, mc.c8, mc.c3, mc.c9)
    )

    def local_mc(block_shape):
        lk, li, lj = block_shape
        k0, i0, j0 = global_offsets(block_shape)
        c1, c7, c2, c8, c3, c9 = tabs

        def sl(tab, start, n):
            return lax.dynamic_slice(tab, (start,), (n + 2,))

        return MafCoeffs(
            c1=sl(c1, i0, li)[None, :, None],
            c7=sl(c7, i0, li)[None, :, None],
            c2=sl(c2, j0, lj)[None, None, :],
            c8=sl(c8, j0, lj)[None, None, :],
            c3=sl(c3, k0, lk)[:, None, None],
            c9=sl(c9, k0, lk)[:, None, None],
        )

    from ..ops.maf import maf_delta

    def sharded(body):
        return shard_map(
            body,
            mesh=cmesh.mesh,
            in_specs=(FIELD_SPEC, FIELD_SPEC, FIELD_SPEC),
            out_specs=(FIELD_SPEC, P()),
        )

    if kind in ("pcr", "pcr_rb"):
        # block-local MAF K-lines with identity ghost rows (same scheme as
        # the constant-coefficient path above; variable tridiagonal from
        # the block's metric-table slice, cz_maf.f90:519-572)
        lk = g.nk // cmesh.div[0]
        pn = num_stage(lk + 2)

        def line_solve_maf(xh, bh, mh, mcl):
            xcol = xh[:, 1:-1, 1:-1]
            mcol = mh[:, 1:-1, 1:-1]
            bcol = bh[:, 1:-1, 1:-1]
            c3 = mcl.c3            # (lk+2, 1, 1) ghosted
            c9 = mcl.c9
            c1 = mcl.c1[:, 1:-1, :]  # (1, li, 1) inner
            c7 = mcl.c7[:, 1:-1, :]
            c2 = mcl.c2[:, :, 1:-1]
            c8 = mcl.c8[:, :, 1:-1]
            half = jnp.asarray(0.5, dtype)
            dw = half / (c1 + c2 + c3)
            a = (-(c3 - half * c9) * dw) * mcol
            c = (-(c3 + half * c9) * dw) * mcol
            trans = (
                (c1 + half * c7) * xh[:, 2:, 1:-1]
                + (c1 - half * c7) * xh[:, :-2, 1:-1]
                + (c2 + half * c8) * xh[:, 1:-1, 2:]
                + (c2 - half * c8) * xh[:, 1:-1, :-2]
            )
            d = ((trans - bcol) * dw) * mcol + xcol * (1.0 - mcol)
            return pcr_ops.pcr_reduce_var(a, c, d, pn)

        if kind == "pcr":

            def body(xb, bb, mb):
                xh = exchange_halo(xb)
                mcl = local_mc(xb.shape)
                sol = line_solve_maf(xh, pad_zeros(bb), pad_zeros(mb), mcl)
                dp = (sol[1:-1] - xb) * om * mb
                return xb + dp, psum_all(jnp.sum(dp * dp))

        else:

            def body(xb, bb, mb):
                r2 = jnp.zeros((), dtype)
                lm0, lm1 = _global_line_masks(xb.shape, dtype)
                mcl = local_mc(xb.shape)
                for lm in (lm0, lm1):
                    xh = exchange_halo(xb)
                    sol = line_solve_maf(xh, pad_zeros(bb), pad_zeros(mb), mcl)
                    dp = (sol[1:-1] - xb) * om * mb * lm
                    xb = xb + dp
                    r2 = r2 + psum_all(jnp.sum(dp * dp))
                return xb, r2

        fn = sharded(body)
        return lambda x, b: fn(x, b, msk)

    if kind == "jacobi":

        def body(xb, bb, mb):
            xh = exchange_halo(xb)
            mcl = local_mc(xb.shape)
            dp = _interior(maf_delta(xh, pad_zeros(bb), pad_zeros(mb), om, mcl))
            return xb + dp, psum_all(jnp.sum(dp * dp))

    else:  # sor2sma

        def body(xb, bb, mb):
            mcl = local_mc(xb.shape)
            cm0, cm1 = _global_color_masks(xb.shape, dtype)
            if sync == "iter":
                return _rb_iter(
                    xb, bb, mb, (cm0, cm1),
                    lambda xh, bh, mh: maf_delta(xh, bh, mh, om, mcl),
                )
            bh, r2 = pad_zeros(bb), jnp.zeros((), dtype)
            for cm in (cm0, cm1):
                xh = exchange_halo(xb)
                dp = _interior(maf_delta(xh, bh, pad_zeros(mb * cm), om, mcl))
                xb = xb + dp
                r2 = r2 + psum_all(jnp.sum(dp * dp))
            return xb, r2

    fn = sharded(body)
    return lambda x, b: fn(x, b, msk)


def __parse(name):
    from ..solvers.steps import parse_name

    return parse_name(name)
