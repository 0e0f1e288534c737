"""Fast lexicographic point-SOR via diagonal-plane affine scans.

The reference's psor (cz_solver.f90:207-269) is serial Gauss-Seidel in
(j, i, k) order.  Its data-dependency DAG admits the classic hyperplane
ordering (i+j+k = const), but updating one masked hyperplane per step does
O(N^3) work for O(N^2) updates — O(N^4) per sweep (an earlier
implementation, kept in ops/stencil.py::psor_sweep for bitwise
reference).  This module restores O(N^3) per sweep with two observations:

1. **K-lines are affine recurrences.**  Within a line (i, j), the GS update
   is x(k) = a(k) * x(k-1) + u(k) where every u(k) term is known before the
   line starts (transverse neighbors at i-1/j-1 are NEW, i+1/j+1 and k+1 are
   OLD) — a first-order linear recurrence, solved in log2(K) steps by
   ``jax.lax.associative_scan`` over composed affine maps.  For the constant
   operator a = omega/6; for MAF a(k) = omega * wzm(k)/dd(k)
   (cz_maf.f90:94-105).

2. **Lines form a 2D wavefront.**  Line (i, j) needs lines (i-1, j) and
   (i, j-1) new, (i+1, j) and (i, j+1) old — so all lines on diagonal
   d = i+j update together, and a sweep is a fori_loop over 2N-3 diagonals
   (vs 3N-4 hyperplanes), each step O(K * N_lines) work.

Layout choices (a first cut with a gather-based skew and dynamic slices
along the last axis ran slower than the hyperplane form):

* **Gather-free skew.**  S[k, i, d] = X[k, i, d-i] is a *strided reshape*:
  pad the J axis to W = ni+nj, flatten (i, j), and re-read with row stride
  W-1 — rows shift by one per i, aligning diagonal d at position d.  The
  inverse is the same trick with stride W.  Both are dense copies XLA
  handles as relayouts, never scalar gathers.
* **Diagonal axis LEADING.**  The per-diagonal loop slices and updates
  S[d] as a contiguous (K, I) slab on the major axis (alias-friendly
  dynamic_update_slice inside the fori carry); the associative scan's
  shifted adds run over (K, I).
* **State stays skewed across the whole solve** — step._pre / step._post
  convert once per solve (the driver folds them into the loop executable),
  not once per sweep.

Same dependency order as the serial reference -> same iteration counts; the
affine-scan association changes rounding (like every other solver here vs
the Fortran loops), so histories agree to fp tolerance, not bitwise.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def _affine_combine(left, right):
    # x -> a2*(a1*x + u1) + u2 = (a1*a2)*x + (a2*u1 + u2)
    a1, u1 = left
    a2, u2 = right
    return a1 * a2, a2 * u1 + u2


def make_skew(shape_kij, dtype):
    """(skew, unskew, D): strided-reshape converters between (K, I, J) and
    the diagonal layout (D, K, I) with S[d, k, i] = X[k, i, d-i] (zero where
    d-i is outside [0, nj))."""
    nk, ni, nj = shape_kij
    W = ni + nj
    D = W - 1

    def skew(x):
        p = jnp.pad(x, ((0, 0), (0, 0), (0, W - nj)))  # (nk, ni, W)
        flat = p.reshape(nk, ni * W)[:, : ni * (W - 1)]
        s = flat.reshape(nk, ni, W - 1)  # s[k,i,d] = x[k,i,d-i]
        return jnp.transpose(s, (2, 0, 1))  # (D, nk, ni)

    def unskew(s):
        c = jnp.transpose(s, (1, 2, 0)).reshape(nk, ni * (W - 1))
        flat = jnp.pad(c, ((0, 0), (0, ni)))  # length ni*W
        return flat.reshape(nk, ni, W)[:, :, :nj]

    return skew, unskew, D


def make_psor_diag_step(shape_kij, dtype, omega, mc=None):
    """Build ``step(S, B) -> (S_new, sum(dp^2))`` on the skewed (D, K, I)
    layout — one full lexicographic point-SOR sweep (psor / psor_maf
    semantics).  ``step._pre`` / ``step._post`` hold the layout converters.

    ``mc``: MafCoeffs for the variable-coefficient form (psor_maf,
    cz_maf.f90:23-114); None = constant coefficients (cz_solver.f90:207-269).
    """
    nk, ni, nj = shape_kij
    skew, unskew, D = make_skew(shape_kij, dtype)

    # line validity per (d, i): 1 <= i <= ni-2 and 1 <= d-i <= nj-2
    ii = np.arange(ni)[None, :]
    dd_ = np.arange(D)[:, None]
    jj = dd_ - ii
    line_np = (ii >= 1) & (ii <= ni - 2) & (jj >= 1) & (jj <= nj - 2)
    line_ok = jnp.asarray(line_np, dtype=dtype)  # (D, ni)
    kin = ((np.arange(nk) >= 1) & (np.arange(nk) <= nk - 2))
    kin = jnp.asarray(kin, dtype=dtype)[:, None]  # (nk, 1)

    om = jnp.asarray(omega, dtype)
    one = jnp.asarray(1.0, dtype)

    if mc is not None:
        c1 = jnp.asarray(mc.c1, dtype).reshape(-1)  # (ni,)
        c7 = jnp.asarray(mc.c7, dtype).reshape(-1)
        c2 = np.asarray(mc.c2, dtype).reshape(-1)  # (nj,) host: skew tables
        c8 = np.asarray(mc.c8, dtype).reshape(-1)
        c3 = jnp.asarray(mc.c3, dtype).reshape(-1)  # (nk,)
        c9 = jnp.asarray(mc.c9, dtype).reshape(-1)
        half = jnp.asarray(0.5, dtype)
        wxp_i = (c1 + half * c7)[None, :]  # (1, ni)
        wxm_i = (c1 - half * c7)[None, :]
        wzp_k = (c3 + half * c9)[:, None]  # (nk, 1)
        wzm_k = (c3 - half * c9)[:, None]
        jsafe = np.clip(jj, 0, nj - 1)
        wyp_di = jnp.asarray((c2 + 0.5 * c8)[jsafe], dtype)  # (D, ni)
        wym_di = jnp.asarray((c2 - 0.5 * c8)[jsafe], dtype)
        c2_di = jnp.asarray(c2[jsafe], dtype)  # (D, ni)
    else:
        r6 = jnp.asarray(1.0 / 6.0, dtype)
        a_const = om * r6

    def step(S, B):
        def body(d, carry):
            S, r2 = carry
            xc = jax.lax.dynamic_slice_in_dim(S, d, 1, 0)[0]  # (nk, ni)
            xm1 = jax.lax.dynamic_slice_in_dim(S, d - 1, 1, 0)[0]
            xp1 = jax.lax.dynamic_slice_in_dim(S, d + 1, 1, 0)[0]
            bc = jax.lax.dynamic_slice_in_dim(B, d, 1, 0)[0]
            lm = jax.lax.dynamic_slice_in_dim(line_ok, d, 1, 0)[0]  # (ni,)

            # transverse neighbors in skewed coords:
            #   (i-1, j) -> S[d-1][:, i-1] (NEW)   (i, j-1) -> S[d-1][:, i]
            #   (i+1, j) -> S[d+1][:, i+1] (OLD)   (i, j+1) -> S[d+1][:, i]
            xm1_im1 = jnp.pad(xm1[:, :-1], ((0, 0), (1, 0)))
            xp1_ip1 = jnp.pad(xp1[:, 1:], ((0, 0), (0, 1)))
            x_kp1 = jnp.pad(xc[1:], ((0, 1), (0, 0)))  # OLD (k+1)

            if mc is None:
                T = xm1_im1 + xm1 + xp1_ip1 + xp1
                u = (one - om) * xc + om * r6 * (T - bc + x_kp1)
                a = jnp.broadcast_to(a_const, xc.shape)
            else:
                wyp = jax.lax.dynamic_slice_in_dim(wyp_di, d, 1, 0)[0]
                wym = jax.lax.dynamic_slice_in_dim(wym_di, d, 1, 0)[0]
                c2d = jax.lax.dynamic_slice_in_dim(c2_di, d, 1, 0)[0]
                idd = one / (2.0 * (c1[None, :] + c2d[None, :] + c3[:, None]))
                T = (
                    wxm_i * xm1_im1
                    + wym[None, :] * xm1
                    + wxp_i * xp1_ip1
                    + wyp[None, :] * xp1
                )
                # MAF takes rp + b (cz_maf.f90:101) — note the + sign
                u = (one - om) * xc + om * idd * (T + bc + wzp_k * x_kp1)
                a = om * wzm_k * idd

            # affine recurrence x(k) = a(k) x(k-1) + u(k); x(0) is the
            # Dirichlet value, seeded as (a=0, u=x(0)) so the prefix scan
            # threads it through every x(k)
            a = jnp.concatenate([jnp.zeros_like(a[:1]), a[1:]], axis=0)
            u = jnp.concatenate([xc[:1], u[1:]], axis=0)
            _, xnew = jax.lax.associative_scan(_affine_combine, (a, u),
                                               axis=0)
            dp = (xnew - xc) * (kin * lm[None, :])
            S = jax.lax.dynamic_update_slice_in_dim(
                S, (xc + dp)[None], d, 0
            )
            return S, r2 + jnp.sum(dp * dp)

        return jax.lax.fori_loop(
            2, ni + nj - 4 + 1, body, (S, jnp.zeros((), dtype))
        )

    step._pre = skew
    step._post = unskew
    return step
