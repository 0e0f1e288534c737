"""Fast lexicographic line-Gauss-Seidel (the reference `pcr` serial form).

The reference's full-plane pcr relaxes each line inside the lexicographic
(j, i) loop (cz_solver.f90:848-856), so its serial semantics are line-GS.
Line (i, j) reads updated lines (i-1, j) and (i, j-1) — diagonal i+j-1 —
and old lines (i+1, j), (i, j+1) — diagonal i+j+1: the same 2D diagonal
wavefront as point-SOR, one level up.  An earlier implementation solved
ALL lines every diagonal and masked one diagonal's update — O(N) full-plane
line solves per sweep.

Here a sweep is a fori_loop over the 2N-3 diagonals in the SKEWED layout of
ops/psor_scan.py (S[d, k, i] = X[k, i, d-i], gather-free strided-reshape
converters, diagonal axis leading), and each step solves ONLY that
diagonal's lines: an (n_inner, ni, 1) batch through the same PCR stage
tables (pcr_reduce_const / pcr_reduce_var, ops/pcr.py) the production
pcr_rb path uses — identical line arithmetic to the reference's PCR stages
+ 2x2 final.  O(N^3 log N) per sweep, ~250 sequential steps.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from . import pcr as pcr_ops
from .psor_scan import make_skew

R6 = 1.0 / 6.0


def make_pcr_gs_diag_step(shape_kij, dtype, omega, mc=None,
                          kst=1, ked=None):
    """Build ``step(S, B) -> (S_new, sum(dp^2))`` on the skewed (D, K, I)
    layout — one lexicographic line-GS sweep (pcr / pcr_eda / pcr_esa and
    their _maf forms).  ``step._pre`` / ``step._post`` hold the layout
    converters."""
    nk, ni, nj = shape_kij
    if ked is None:
        ked = nk - 2
    n = ked - kst + 1
    skew, unskew, D = make_skew(shape_kij, dtype)

    ii = np.arange(ni)[None, :]
    dd_ = np.arange(D)[:, None]
    jj = dd_ - ii
    line_np = (ii >= 1) & (ii <= ni - 2) & (jj >= 1) & (jj <= nj - 2)
    line_ok = jnp.asarray(line_np, dtype=dtype)  # (D, ni)

    om = jnp.asarray(omega, dtype)
    half = jnp.asarray(0.5, dtype)

    if mc is None:
        plan = pcr_ops.build_pcr_plan(n, dtype)
        r6 = jnp.asarray(R6, dtype)
    else:
        pn = pcr_ops.num_stage(n)
        c1 = jnp.asarray(mc.c1, dtype).reshape(-1)  # (ni,)
        c7 = jnp.asarray(mc.c7, dtype).reshape(-1)
        c2n = np.asarray(mc.c2, dtype).reshape(-1)  # (nj,) host
        c8n = np.asarray(mc.c8, dtype).reshape(-1)
        c3 = jnp.asarray(mc.c3, dtype).reshape(-1)[kst : ked + 1]  # (n,)
        c9 = jnp.asarray(mc.c9, dtype).reshape(-1)[kst : ked + 1]
        wxp_i = (c1 + half * c7)[None, :]  # (1, ni)
        wxm_i = (c1 - half * c7)[None, :]
        jsafe = np.clip(jj, 0, nj - 1)
        wyp_di = jnp.asarray((c2n + 0.5 * c8n)[jsafe], dtype)  # (D, ni)
        wym_di = jnp.asarray((c2n - 0.5 * c8n)[jsafe], dtype)
        c2_di = jnp.asarray(c2n[jsafe], dtype)
        # K-axis weight tables of the variable tridiagonal
        # (pcr_rb_maf coefficient construction, cz_maf.f90:533-554)
        wz_lo = (c3 - half * c9)[:, None]  # (n, 1): weight of x(k-1)
        wz_hi = (c3 + half * c9)[:, None]  # weight of x(k+1)

    def step(S, B):
        def body(d, carry):
            S, r2 = carry
            xc = jax.lax.dynamic_slice_in_dim(S, d, 1, 0)[0]  # (nk, ni)
            xm1 = jax.lax.dynamic_slice_in_dim(S, d - 1, 1, 0)[0]
            xp1 = jax.lax.dynamic_slice_in_dim(S, d + 1, 1, 0)[0]
            bc = jax.lax.dynamic_slice_in_dim(B, d, 1, 0)[0]
            lm = jax.lax.dynamic_slice_in_dim(line_ok, d, 1, 0)[0]  # (ni,)

            xm1_im1 = jnp.pad(xm1[:, :-1], ((0, 0), (1, 0)))  # (i-1, j) NEW
            xp1_ip1 = jnp.pad(xp1[:, 1:], ((0, 0), (0, 1)))  # (i+1, j) OLD

            sl = slice(kst, ked + 1)
            if mc is None:
                trans = xm1_im1 + xm1 + xp1_ip1 + xp1
                dline = ((trans - bc) * r6)[sl]
                # boundary fold (cz_solver.f90:578-579)
                dline = dline.at[0].add(xc[kst - 1] * r6)
                dline = dline.at[-1].add(xc[ked + 1] * r6)
                sol = pcr_ops.pcr_reduce_const(dline[..., None], plan)[..., 0]
            else:
                c2d = jax.lax.dynamic_slice_in_dim(c2_di, d, 1, 0)[0]
                wyp = jax.lax.dynamic_slice_in_dim(wyp_di, d, 1, 0)[0]
                wym = jax.lax.dynamic_slice_in_dim(wym_di, d, 1, 0)[0]
                dw = half / (c1[None, :] + c2d[None, :] + c3[:, None])  # (n,ni)
                a = jnp.broadcast_to(-wz_lo * dw, dw.shape)
                c = jnp.broadcast_to(-wz_hi * dw, dw.shape)
                a = jnp.concatenate([jnp.zeros_like(a[:1]), a[1:]], axis=0)
                c = jnp.concatenate([c[:-1], jnp.zeros_like(c[-1:])], axis=0)
                trans = (
                    wxp_i * xp1_ip1
                    + wxm_i * xm1_im1
                    + wyp[None, :] * xp1
                    + wym[None, :] * xm1
                )
                # line MAF takes (trans - rhs) (cz_maf.f90:558-566)
                dline = ((trans - bc)[sl]) * dw
                dline = dline.at[0].add((wz_lo[0] * dw[0]) * xc[kst - 1])
                dline = dline.at[-1].add((wz_hi[-1] * dw[-1]) * xc[ked + 1])
                sol = pcr_ops.pcr_reduce_var(
                    a[..., None], c[..., None], dline[..., None], pn
                )[..., 0]

            dp = (sol - xc[sl]) * om * lm[None, :]
            xcol = xc.at[sl].add(dp)
            S = jax.lax.dynamic_update_slice_in_dim(S, xcol[None], d, 0)
            return S, r2 + jnp.sum(dp * dp)

        return jax.lax.fori_loop(
            2, ni + nj - 4 + 1, body, (S, jnp.zeros((), dtype))
        )

    step._pre = skew
    step._post = unskew
    return step
