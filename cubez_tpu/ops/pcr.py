"""Batched line-PCR along K for the LSOR solver family.

JAX re-design of the reference PCR kernels (pcr / pcr_rb / pcr_eda /
pcr_esa / pcr_rb_esa / pcr_j_esa, cz_solver.f90:497-1676, and their MAF twins
cz_maf.f90:442-1560).

Key deviations from the reference, all performance-motivated and
result-preserving:

* **All (i,j) lines are solved at once** as (K, I, J) tensors instead of
  per-line 1D work arrays — the stage recurrence becomes a handful of fused
  elementwise ops with cheap major-axis shifts.
* **Constant-coefficient a/c/e stage tables are precomputed once** as 1D
  arrays over k ("PCRPlan"): for cf=(1,..,1,6) the coefficient evolution is
  independent of the line, so the reference's per-line recompute
  (14 of its 14+6 flops/pt/stage) is hoisted out of the iteration entirely.
  Only the RHS ``d`` is updated per stage.
* **One final form**: stages run to pn-1 followed by a direct 2x2 pair
  inversion.  The reference's pn-2 + 4x4-Cramer split (pcr, pcr_esa) is an
  algebraically identical early-exit of the same reduction — CubeZ itself
  documents identical iteration histories across its variants
  (doc/Memo.md:134) — so eda/esa/4x4 collapse into this one kernel.
* Zero-extension replaces the reference's index clamping
  (max/min of cz_solver.f90:589-597 vs. the zero-padded arrays of
  cz_solver.f90:919-929); identical arithmetic because the padded
  coefficients are exactly zero.

The line system along K for the 7-pt operator is
    -1/6 x[k-1] + x[k] - 1/6 x[k+1] = d[k]
    d = (transverse 4-neighbor sum - rhs)/6 * msk,
with the halo/boundary ends folded in:
    d[kst] += x[kst-1]/6,  d[ked] += x[ked+1]/6   (cz_solver.f90:578-579).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .shifts import shift
from .tdma import num_stage
from .maf import MafCoeffs

R6 = 1.0 / 6.0


def _np_shift(x: np.ndarray, d: int) -> np.ndarray:
    out = np.zeros_like(x)
    if d == 0:
        return x.copy()
    if d > 0:
        out[:-d] = x[d:]
    else:
        out[-d:] = x[:d]
    return out


@dataclasses.dataclass(frozen=True)
class PCRPlan:
    """Precomputed per-stage coefficient tables for a constant-coefficient
    line of length n (depends only on n, not on the field)."""

    n: int
    pn: int
    # per stage p: (ap, cp, e) each shaped (n, 1, 1)
    stages: tuple
    # final 2x2 pair inversion tables, each (s, 1, 1) with s = 2^(pn-1)
    c_lo: jnp.ndarray
    a_hi: jnp.ndarray
    jj: jnp.ndarray


def build_pcr_plan(n: int, dtype=jnp.float32) -> PCRPlan:
    """Evolve a = c = -1/6 (ends zero) through the PCR stages in float64 and
    freeze the per-stage (a, c, e) tables."""
    pn = num_stage(n)
    a = np.full(n, -R6, np.float64)
    c = np.full(n, -R6, np.float64)
    a[0] = 0.0
    c[-1] = 0.0

    def col(v):
        return jnp.asarray(v, dtype)[:, None, None]

    stages = []
    for p in range(1, pn):
        s = 2 ** (p - 1)
        al, ar = _np_shift(a, -s), _np_shift(a, s)
        cl, cr = _np_shift(c, -s), _np_shift(c, s)
        e = 1.0 / (1.0 - a * cl - c * ar)
        stages.append((col(a), col(c), col(e)))
        a, c = -e * a * al, -e * c * cr

    s = 2 ** (pn - 1)
    a_hi = np.zeros(s, np.float64)
    a_hi[: max(n - s, 0)] = a[s:]
    c_lo = c[:s].copy()
    jj = 1.0 / (1.0 - a_hi * c_lo)
    return PCRPlan(
        n=n, pn=pn, stages=tuple(stages), c_lo=col(c_lo), a_hi=col(a_hi), jj=col(jj)
    )


def build_line_rhs(x, rhs, msk, kst: int, ked: int):
    """d over the inner K range [kst, ked] (0-based inclusive), shape
    (n, I, J): transverse source + boundary fold (cz_solver.f90:566-579)."""
    r = jnp.asarray(R6, x.dtype)
    trans = (
        shift(x, 1, +1) + shift(x, 1, -1) + shift(x, 2, +1) + shift(x, 2, -1)
    )
    d = ((trans - rhs) * r * msk)[kst : ked + 1]
    mk = msk[kst : ked + 1]
    d = d.at[0].add(x[kst - 1] * r)
    d = d.at[0].multiply(mk[0])
    d = d.at[-1].add(x[ked + 1] * r)
    d = d.at[-1].multiply(mk[-1])
    return d


def pcr_reduce_const(d, plan: PCRPlan):
    """Run the stage recurrence + final 2x2 on d (n, I, J) using frozen
    constant-coefficient tables; returns the line solution (n, I, J)."""
    for p, (ap, cp, e) in enumerate(plan.stages, start=1):
        s = 2 ** (p - 1)
        dl = shift(d, 0, -s)
        dr = shift(d, 0, +s)
        d = e * (d - ap * dl - cp * dr)

    s = 2 ** (plan.pn - 1)
    n = plan.n
    pad = ((0, 2 * s - n), (0, 0), (0, 0))
    d_hi = jnp.pad(d, pad)[s : 2 * s]
    d_lo = d[:s]
    x_lo = (d_lo - plan.c_lo * d_hi) * plan.jj
    x_hi = (d_hi - plan.a_hi * d_lo) * plan.jj
    return jnp.concatenate([x_lo, x_hi], axis=0)[:n]


def pcr_reduce_var(a, c, d, pn: int):
    """Variable-coefficient PCR (a, c, d all (n, I, J)) — used by the MAF
    line solvers, where the tridiagonal varies per line
    (pcr_rb_maf, cz_maf.f90:442-668)."""
    n = d.shape[0]
    for p in range(1, pn):
        s = 2 ** (p - 1)
        al, cl, dl = shift(a, 0, -s), shift(c, 0, -s), shift(d, 0, -s)
        ar, cr, dr = shift(a, 0, +s), shift(c, 0, +s), shift(d, 0, +s)
        e = 1.0 / (1.0 - a * cl - c * ar)
        a, c, d = -e * a * al, -e * c * cr, e * (d - a * dl - c * dr)

    s = 2 ** (pn - 1)
    pad = ((0, 2 * s - n), (0, 0), (0, 0))
    d_hi = jnp.pad(d, pad)[s : 2 * s]
    a_hi = jnp.pad(a, pad)[s : 2 * s]
    c_lo = c[:s]
    d_lo = d[:s]
    jj = 1.0 / (1.0 - a_hi * c_lo)
    x_lo = (d_lo - c_lo * d_hi) * jj
    x_hi = (d_hi - a_hi * d_lo) * jj
    return jnp.concatenate([x_lo, x_hi], axis=0)[:n]


def build_line_system_maf(x, rhs, msk, mc: MafCoeffs, kst: int, ked: int):
    """Variable tridiagonal (a, c, d) over the inner K range, normalized to a
    unit diagonal by dw = 0.5/(C1+C2+C3) (pcr_rb_maf, cz_maf.f90:519-572)."""
    sl = slice(kst, ked + 1)
    c3 = mc.c3[sl]
    c9 = mc.c9[sl]
    dw = 0.5 / (mc.c1 + mc.c2 + c3)  # (n, I, J) broadcast
    one = jnp.ones_like(x[sl])
    a = (-(c3 - 0.5 * c9) * dw) * one
    c = (-(c3 + 0.5 * c9) * dw) * one
    a = a.at[0].set(0.0)
    c = c.at[-1].set(0.0)

    trans = (
        mc.wxp * shift(x, 1, +1)
        + mc.wxm * shift(x, 1, -1)
        + mc.wyp * shift(x, 2, +1)
        + mc.wym * shift(x, 2, -1)
    )
    d = (((trans - rhs)[sl]) * dw * msk[sl])
    mk = msk[sl]
    # boundary fold with the true z-weights (cz_maf.f90:571-572)
    wlo = ((c3 - 0.5 * c9) * dw)[0]
    whi = ((c3 + 0.5 * c9) * dw)[-1]
    d = d.at[0].add(wlo * x[kst - 1])
    d = d.at[0].multiply(mk[0])
    d = d.at[-1].add(whi * x[ked + 1])
    d = d.at[-1].multiply(mk[-1])
    return a, c, d


def line_color_masks(ni: int, nj: int, color_offset: int = 0, dtype=jnp.float32):
    """(I, J) line parity masks for the red-black line sweeps: color c updates
    lines with (i + j) % 2 == c in the reference's 1-based indexing, i.e.
    (i0 + j0) % 2 == c 0-based (pcr_rb, cz_solver.f90:549).  ``color_offset``
    generalizes to global parity for multi-block runs (the reference computes
    but never applies it — cz_Poisson.cpp:549/cz_solver.f90:1300-1301)."""
    ii = np.arange(ni)[:, None]
    jj = np.arange(nj)[None, :]
    par = (ii + jj + color_offset) % 2
    return (
        jnp.asarray(par == 0, dtype=dtype)[None, :, :],
        jnp.asarray(par == 1, dtype=dtype)[None, :, :],
    )
