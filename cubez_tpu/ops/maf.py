"""MAF (matrix-assembly-free) variable-coefficient operators.

The reference recomputes metric terms from the 1D coordinate arrays inside
every kernel (cz_maf.f90, cz_blas.f90:738-1039).  Here we exploit that every
metric factor is separable per axis: C1,C7 depend only on i; C2,C8 only on j;
C3,C9 only on k.  We precompute six 1D coefficient arrays shaped for
broadcasting over (K, I, J) — the variable-coefficient sweeps then cost barely
more HBM traffic than the constant-coefficient ones (the reference pays 66
flop/pt recomputing metrics; here XLA fuses the broadcasts for free).

Metric definitions (psor_maf, cz_maf.f90:68-101):
    XG = 0.5 (X[i+1] - X[i-1]),  XGG = X[i+1] - 2 X[i] + X[i-1]
    GX = 1/XG   (via the Jacobian identity YE*ZT/(XG*YE*ZT))
    C1 = GX^2,  C7 = -XGG * C1 * GX      (same pattern for Y->C2,C8, Z->C3,C9)
    neighbor weights:  x+/-: C1 +/- 0.5 C7,  y: C2 +/- 0.5 C8,  z: C3 +/- 0.5 C9
    diagonal:          dd = 2 (C1 + C2 + C3)
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from .shifts import nbr6


def _central(arr: jnp.ndarray):
    """(first, second) central differences of a 1D coord array; edge entries
    use replicated neighbors and are only ever read at masked nodes."""
    ap = jnp.concatenate([arr[1:], arr[-1:]])
    am = jnp.concatenate([arr[:1], arr[:-1]])
    g = 0.5 * (ap - am)
    gg = ap - 2.0 * arr + am
    return g, gg


def _axis_coeffs(arr: jnp.ndarray):
    g, gg = _central(arr)
    # guard the replicated edges (g there is h/2 != 0, but be safe)
    ginv = jnp.where(g != 0, 1.0 / jnp.where(g != 0, g, 1.0), 0.0)
    c = ginv * ginv
    c_odd = -gg * c * ginv
    return c, c_odd


@dataclasses.dataclass(frozen=True)
class MafCoeffs:
    """Separable metric coefficients, broadcast-shaped for (K, I, J)."""

    c1: jnp.ndarray  # (1, ni, 1)
    c7: jnp.ndarray  # (1, ni, 1)
    c2: jnp.ndarray  # (1, 1, nj)
    c8: jnp.ndarray  # (1, 1, nj)
    c3: jnp.ndarray  # (nk, 1, 1)
    c9: jnp.ndarray  # (nk, 1, 1)

    @classmethod
    def from_coords(cls, xc, yc, zc) -> "MafCoeffs":
        c1, c7 = _axis_coeffs(xc)
        c2, c8 = _axis_coeffs(yc)
        c3, c9 = _axis_coeffs(zc)
        return cls(
            c1=c1[None, :, None],
            c7=c7[None, :, None],
            c2=c2[None, None, :],
            c8=c8[None, None, :],
            c3=c3[:, None, None],
            c9=c9[:, None, None],
        )

    # neighbor weights ------------------------------------------------------
    @property
    def wxp(self):
        return self.c1 + 0.5 * self.c7

    @property
    def wxm(self):
        return self.c1 - 0.5 * self.c7

    @property
    def wyp(self):
        return self.c2 + 0.5 * self.c8

    @property
    def wym(self):
        return self.c2 - 0.5 * self.c8

    @property
    def wzp(self):
        return self.c3 + 0.5 * self.c9

    @property
    def wzm(self):
        return self.c3 - 0.5 * self.c9

    @property
    def dd(self):
        """Diagonal 2(C1+C2+C3), broadcastable to (K, I, J)."""
        return 2.0 * (self.c1 + self.c2 + self.c3)

    def nbr_weighted(self, x: jnp.ndarray) -> jnp.ndarray:
        """rp = sum of metric-weighted neighbors (cz_maf.f90:95-101)."""
        xm, xp, ym, yp, zm, zp = nbr6(x)
        return (
            self.wxp * xp
            + self.wxm * xm
            + self.wyp * yp
            + self.wym * ym
            + self.wzp * zp
            + self.wzm * zm
        )

    def pivot(self) -> jnp.ndarray:
        """pvt = 1/max|row coefficient| row scaling (search_pivot,
        cz_blas.f90:947-1039)."""
        zero = jnp.zeros_like(self.dd)
        m = jnp.abs(self.dd + zero)
        for w in (self.wxp, self.wxm, self.wyp, self.wym, self.wzp, self.wzm):
            m = jnp.maximum(m, jnp.abs(w + zero))
        return 1.0 / m


# --- sweeps / BLAS ----------------------------------------------------------


def maf_delta(x, b, msk, omega, mc: MafCoeffs):
    """dp = ((rp + b)/dd - x) * omega on masked nodes (psor_maf,
    cz_maf.f90:94-105)."""
    rp = mc.nbr_weighted(x) + b
    dp = (rp / mc.dd - x) * jnp.asarray(omega, x.dtype)
    return dp * msk


def jacobi_maf_sweep(x, b, msk, omega, mc):
    """jacobi_maf (cz_maf.f90:131-282)."""
    dp = maf_delta(x, b, msk, omega, mc)
    return x + dp, jnp.sum(dp * dp)


def sor2sma_maf_sweep(x, b, msk, omega, mc, cmasks):
    """psor2sma_core_maf over both colors (cz_maf.f90:301-438)."""
    dp = maf_delta(x, b, msk * cmasks[0], omega, mc)
    x = x + dp
    r2 = jnp.sum(dp * dp)
    dp = maf_delta(x, b, msk * cmasks[1], omega, mc)
    return x + dp, r2 + jnp.sum(dp * dp)


def calc_ax_maf(p, msk, mc: MafCoeffs, pvt):
    """ap = (weighted neighbors - dd p) * pvt (calc_ax_maf,
    cz_blas.f90:845-936), masked."""
    return (mc.nbr_weighted(p) - mc.dd * p) * pvt * msk


def calc_rk_maf(p, b, msk, mc: MafCoeffs, pvt):
    """r = (b - (weighted neighbors - dd p)) * pvt (calc_rk_maf,
    cz_blas.f90:738-831), masked."""
    return (b - (mc.nbr_weighted(p) - mc.dd * p)) * pvt * msk
