"""Constant-coefficient 7-point stencil relaxation sweeps.

JAX equivalents of the Fortran90 hot loops (reference file:line in each
docstring).  All sweeps are *masked dense updates* over the full (K, I, J)
node array: ``dp`` is computed everywhere, multiplied by the inner mask (and a
color mask where applicable), and added to ``x``.  Boundary nodes therefore
never change, which makes the per-iteration Dirichlet re-imposition a no-op on
a single device — exactly the single-rank semantics of the reference.

The 7-point operator uses cf = (1,1,1,1,1,1,6): ``ss = sum of 6 neighbors``
and diagonal ``dd = 6`` (cz.h:168-172).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .shifts import nbr6

DD = 6.0  # diagonal coefficient cf[7] (cz.h:172)


def nbr_sum(x: jnp.ndarray) -> jnp.ndarray:
    """Unit-coefficient 6-neighbor sum (the `ss` of cz_solver.f90:251-256)."""
    xm, xp, ym, yp, zm, zp = nbr6(x)
    return xm + xp + ym + yp + zm + zp


def jacobi_delta(x, b, msk, omega):
    """Masked Jacobi update increment dp (jacobi, cz_solver.f90:284-387).

    dp = ((ss - b)/6 - x) * omega  on inner nodes, 0 elsewhere.
    """
    ss = nbr_sum(x)
    dp = ((ss - b) / jnp.asarray(DD, x.dtype) - x) * jnp.asarray(omega, x.dtype)
    return dp * msk


def jacobi_sweep(x, b, msk, omega):
    """One Jacobi iteration; returns (x_new, sum(dp^2)).

    The residual is the reference's RMS-of-update accumulator res1
    (cz_solver.f90:348, 384).
    """
    dp = jacobi_delta(x, b, msk, omega)
    return x + dp, jnp.sum(dp * dp)


def inner_mask_expr(shape_kij, dtype=jnp.float32):
    """Inner mask synthesized from broadcasted_iota — call INSIDE the
    step so that under jit it is a fused expression, not an embedded
    (K, I, J) constant.  At 512^3 the constant form is 536 MB per mask
    baked into the executable; the iota form costs a few integer ops and
    no memory traffic (the same trick the red-black kernel uses).
    Values are identical to ``grid.inner_mask`` — results are bitwise
    unchanged."""
    nk, ni, nj = shape_kij
    kk = jax.lax.broadcasted_iota(jnp.int32, (nk, 1, 1), 0)
    ii = jax.lax.broadcasted_iota(jnp.int32, (1, ni, 1), 1)
    jj = jax.lax.broadcasted_iota(jnp.int32, (1, 1, nj), 2)
    inner = (
        (kk >= 1) & (kk <= nk - 2)
        & (ii >= 1) & (ii <= ni - 2)
        & (jj >= 1) & (jj <= nj - 2)
    )
    return inner.astype(dtype)


def color_masks_expr(shape_kij, offset: int = 0, dtype=jnp.float32):
    """Traced-iota form of :func:`color_masks` (same values, no embedded
    constants) — color masks depend only on the shape, so the steps
    always use this form."""
    nk, ni, nj = shape_kij
    kk = jax.lax.broadcasted_iota(jnp.int32, (nk, 1, 1), 0)
    ii = jax.lax.broadcasted_iota(jnp.int32, (1, ni, 1), 1)
    jj = jax.lax.broadcasted_iota(jnp.int32, (1, 1, nj), 2)
    par = jax.lax.rem(kk + ii + jj + (offset + 1), jnp.asarray(2, jnp.int32))
    return (par == 0).astype(dtype), (par == 1).astype(dtype)


def color_masks(shape_kij, offset: int = 0, dtype=jnp.float32):
    """Checkerboard masks for the 2-color (red/black) sweeps.

    Color ``c`` updates nodes whose 1-based Fortran indices satisfy the
    stride-2 K loop ``k = kst + mod(i+j+ofst+c, 2)`` of psor2sma_core
    (cz_solver.f90:451-466); in 0-based indices that is
    ``(i + j + k + offset + 1) % 2 == c``.  ``offset`` carries the global
    parity for multi-block runs (ip of cz_Poisson.cpp:179-186).
    """
    nk, ni, nj = shape_kij
    kk = np.arange(nk)[:, None, None]
    ii = np.arange(ni)[None, :, None]
    jj = np.arange(nj)[None, None, :]
    par = (kk + ii + jj + offset + 1) % 2
    return (
        jnp.asarray(par == 0, dtype=dtype),
        jnp.asarray(par == 1, dtype=dtype),
    )


def sor_color_sweep(x, b, msk, omega, cmask):
    """One color half-sweep of 2-color SOR (psor2sma_core,
    cz_solver.f90:404-493); in-place Gauss-Seidel semantics are obtained by
    feeding the updated x into the second color's call."""
    dp = jacobi_delta(x, b, msk * cmask, omega)
    return x + dp, jnp.sum(dp * dp)


def sor2sma_sweep(x, b, msk, omega, cmasks):
    """Full red+black iteration; residual accumulated across both colors
    (cz_Poisson.cpp:194-210)."""
    x, r0 = sor_color_sweep(x, b, msk, omega, cmasks[0])
    x, r1 = sor_color_sweep(x, b, msk, omega, cmasks[1])
    return x, r0 + r1


def hyperplane_index(shape_kij) -> jnp.ndarray:
    """i+j+k hyperplane id per node (int32), for exact Gauss-Seidel order."""
    nk, ni, nj = shape_kij
    kk = np.arange(nk, dtype=np.int32)[:, None, None]
    ii = np.arange(ni, dtype=np.int32)[None, :, None]
    jj = np.arange(nj, dtype=np.int32)[None, None, :]
    return jnp.asarray(kk + ii + jj)


def psor_sweep(x, b, msk, omega, hidx):
    """One lexicographic point-SOR iteration via hyperplane (wavefront)
    ordering (psor, cz_solver.f90:207-269).

    For the 7-point stencil, any linear extension of the data-dependency
    order yields the bitwise-identical Gauss-Seidel result; the hyperplane
    order i+j+k=const exposes N^2 parallelism per step.  (The reference's
    OpenMP psor races on in-place updates — cz_solver.f90:243-264 — so this
    matches its *single-thread* behavior, the only well-defined one.)
    """
    nk, ni, nj = x.shape
    smin, smax = 3, (nk - 2) + (ni - 2) + (nj - 2)
    dt = x.dtype

    def body(s, carry):
        xx, r2 = carry
        m = msk * (hidx == s).astype(dt)
        dp = jacobi_delta(xx, b, m, omega)
        return xx + dp, r2 + jnp.sum(dp * dp)

    return jax.lax.fori_loop(smin, smax + 1, body, (x, jnp.zeros((), dt)))
