"""Geometric multigrid — a deliberate EXTENSION beyond the reference.

The reference (kenoogl/CubeZ) stops at single-level relaxation/Krylov
solvers; its headline sor2sma run takes 1813 iterations at 128^3
(cz_Poisson.cpp:159-235 + example invocations, Readme.md:384-392).  A
geometric V-cycle solves the same 7-point Poisson problem in O(10) cycles
independent of grid size — the classic algorithmic win this platform adds
on top of kernel-level parity (documented as an extension in README/PARITY,
like utils/checkpoint.py).

Design:
  * Everything is static-shaped dense array math per level, so the whole
    V-cycle unrolls into one XLA executable: smoothing is the existing
    masked red-black sweep (ops/stencil.py), transfer operators are
    strided slices (restriction) and interleaved stacks (prolongation) —
    no gathers, no data-dependent control flow.
  * Operator convention matches ops/blas.py: ``A x = sum(neighbors) - 6 x``
    and the level equation is ``A x = b`` (calc_ax/calc_rk,
    cz_blas.f90:579-723).  A is the h^2-scaled Laplacian, so the coarse
    (2h) re-discretized equation for the error carries the standard factor
    4 on the restricted residual.
  * Vertex-centered coarsening on the INNER nodes: coarse inner index
    c (1-based) sits at fine inner index 2c, coarse inner count
    mc = floor(m/2) for fine inner count m.  This works for ANY grid size
    (the reference sizes 64/128 are not 2^k+1): when m is even the last
    coarse node is one fine spacing from the wall but is treated as a
    regular H-spaced node — a boundary-local operator inconsistency that
    the post-smoother absorbs (validated by the convergence tests).
  * Restriction: 27-point full weighting = tensor product of 1D
    (1/4, 1/2, 1/4); prolongation: its transpose (trilinear
    interpolation).  Both act on full arrays with a zero boundary shell.

The V-cycle is exposed as a standard ``step(x, b) -> (x_new, r2)`` so the
existing convergence driver (driver.run_iterative: on-device while_loop,
history buffer, eps semantics, <solver>.txt output) applies unchanged.
One "iteration" of solver name ``mg`` = one V(nu1, nu2) cycle.

Residual semantics: relaxation solvers stop on RMS(dp) of their update
(cz_Poisson.cpp:67-77).  A cycle's update is not comparable across
methods, so ``mg`` stops on the omega=1 Jacobi-equivalent update
``RMS((b - A x)/6)`` — the dp a unit-omega point sweep would take from
the current iterate.  This makes eps directly comparable with the
reference's jacobi criterion and is computed AFTER each cycle.

The variable-coefficient cycle (solver name ``mg_maf``) swaps in the MAF
metric operator per level — see :func:`make_mg_step` (``maf=True``) for
the convention differences (operator from coarsened coordinates, no
factor 4 on the residual transfer, stopping update r/dd).

Full multigrid (solver names ``fmg`` / ``fmg_maf``) prepends ONE F-cycle
as the initial guess: the RHS is restricted down the hierarchy, the
coarsest level is solved outright from its own Dirichlet shell, and the
solution is interpolated up one level at a time with a V-cycle at each —
the textbook O(N) path to discretization-level error in a single pass.
Boundary data transfers by injection (the coarse shell nodes ARE fine
shell nodes), so every level solves the true boundary-value problem, not
a zero-BC defect equation.  The driver then runs plain V-cycles from
that start: ``fmg`` typically stops after 1-2 cycles where ``mg`` needs
6-8 (same eps semantics and history format).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..core.grid import Grid
from ..ops import stencil
from ..ops.blas import calc_rk


def _restrict1(r, axis: int, mc: int):
    """Full-weighting restriction along one axis of a full (shell-padded)
    array: coarse inner c=1..mc reads fine inner 2c-1, 2c, 2c+1 (all in
    bounds: 2mc+1 <= m+1 = wall index).  Output has extent mc+2 with a
    zero shell along ``axis``."""
    sl = lambda s, e: tuple(
        slice(s, e, 2) if a == axis else slice(None) for a in range(r.ndim)
    )
    mid = r[sl(2, 2 * mc + 1)]
    lo = r[sl(1, 2 * mc)]
    hi = r[sl(3, 2 * mc + 2)]
    quarter = jnp.asarray(0.25, r.dtype)
    half = jnp.asarray(0.5, r.dtype)
    core = lo * quarter + mid * half + hi * quarter
    pad = [(0, 0)] * r.ndim
    pad[axis] = (1, 1)
    return jnp.pad(core, pad)


def _prolong1(e, axis: int, m: int):
    """Trilinear prolongation along one axis: fine inner 2c gets the coarse
    value, odd fine inner points the mean of their two coarse neighbours
    (zero shell supplies the wall ends).  Output has extent m+2 with a
    zero shell along ``axis``."""
    nd = e.ndim
    sl = lambda s, e_: tuple(
        slice(s, e_) if a == axis else slice(None) for a in range(nd)
    )
    mc = e.shape[axis] - 2
    ec = e[sl(1, mc + 1)]  # coarse inner values
    half = jnp.asarray(0.5, e.dtype)
    # odd fine inner index 2c+1 for c=0..mc: (e[c] + e[c+1]) / 2 with the
    # zero shell standing in for the walls
    odd = (e[sl(0, mc + 1)] + e[sl(1, mc + 2)]) * half
    # interleave: fine inner index 1..2mc+1 = odd[0], ec[0], odd[1], ...
    inter = jnp.stack([odd[sl(0, mc)], ec], axis=axis + 1)
    shp = list(ec.shape)
    shp[axis] = 2 * mc
    inter = inter.reshape(tuple(shp))
    body = jnp.concatenate([inter, odd[sl(mc, mc + 1)]], axis=axis)
    # body covers fine inner 1..2mc+1.  For even m that last position is
    # the WALL (2mc+1 = m+1): truncate to the m inner entries so the
    # documented zero shell holds; for odd m (2mc+1 = m) this is a no-op.
    body = body[sl(0, m)]
    pad = [(0, 0)] * nd
    pad[axis] = (1, 1)
    return jnp.pad(body, pad)


def restrict_fw(r, coarse_shape):
    """27-point full-weighting (K, I, J) restriction onto ``coarse_shape``
    (full extents, zero shell)."""
    for ax in range(3):
        r = _restrict1(r, ax, coarse_shape[ax] - 2)
    return r


def prolong(e, fine_shape):
    """Trilinear (K, I, J) prolongation onto ``fine_shape`` (full extents,
    zero shell)."""
    for ax in range(3):
        e = _prolong1(e, ax, fine_shape[ax] - 2)
    return e


@dataclasses.dataclass(frozen=True)
class _Level:
    shape: tuple[int, int, int]  # full extents (K, I, J)
    msk: jnp.ndarray
    cmasks: tuple[jnp.ndarray, jnp.ndarray]
    mc: object = None  # MafCoeffs for the variable-coefficient cycle


def _inner_mask(shape, dtype):
    m = np.zeros(shape, dtype=np.float64)
    m[1:-1, 1:-1, 1:-1] = 1.0
    return jnp.asarray(m, dtype=dtype)


def _coarsen_coords(c, m: int):
    """Coordinates of the coarse nodes along one axis: the walls plus the
    fine nodes 2c (c = 1..m//2).  For even fine inner extent the last
    coarse node sits one FINE spacing from the wall; MafCoeffs.from_coords
    derives the metric from the actual spacings, so the variable-
    coefficient coarse operator is geometry-exact there (the constant-
    coefficient cycle treats it as a regular H-spaced node instead —
    module docstring)."""
    mcc = m // 2
    return jnp.concatenate([c[0:1], c[2 : 2 * mcc + 1 : 2], c[-1:]])


def build_levels(shape_kij, dtype, min_inner: int = 2,
                 coords=None) -> list[_Level]:
    """Level hierarchy from the fine grid down to min(inner) <= min_inner.

    ``coords``: optional (zc, xc, yc) 1D node-coordinate arrays matching
    the (K, I, J) axes — builds a MafCoeffs per level (variable-
    coefficient cycle) from the coarsened coordinates."""
    from ..ops.maf import MafCoeffs

    levels = []
    shape = tuple(int(s) for s in shape_kij)
    while True:
        mc = None
        if coords is not None:
            zc, xc, yc = coords
            mc = MafCoeffs.from_coords(xc, yc, zc)
        levels.append(
            _Level(
                shape=shape,
                msk=_inner_mask(shape, dtype),
                cmasks=stencil.color_masks(shape, dtype=dtype),
                mc=mc,
            )
        )
        inner = [s - 2 for s in shape]
        if min(inner) // 2 <= min_inner:
            break
        if coords is not None:
            zc, xc, yc = coords
            coords = (
                _coarsen_coords(zc, inner[0]),
                _coarsen_coords(xc, inner[1]),
                _coarsen_coords(yc, inner[2]),
            )
        shape = tuple(m // 2 + 2 for m in inner)
    return levels


def _inject_coarse(f, coarse_shape):
    """Coarsen a full (shell-carrying) array by INJECTION at the coarse
    node positions: full-array index 0, 2c (c = 1..mc), n-1 per axis —
    the same index pattern as :func:`_coarsen_coords`, so the values land
    exactly on the coarse nodes for both the regular-H and the
    even-extent boundary-local geometries.  Used to carry Dirichlet
    shells down the FMG hierarchy (the coarse shell nodes ARE fine shell
    nodes, so injection is exact boundary data)."""
    for ax in range(3):
        n = f.shape[ax]
        mc = coarse_shape[ax] - 2
        idx = np.r_[0, np.arange(2, 2 * mc + 1, 2), n - 1]
        f = jnp.take(f, jnp.asarray(idx), axis=ax)
    return f


def make_mg_step(
    grid: Grid,
    omega: float = 1.0,
    nu1: int = 1,
    nu2: int = 1,
    coarse_sweeps: int = 16,
    maf: bool = False,
    fmg: bool = False,
    bc_shell=None,
):
    """Build ``step(x, b) -> (x_new, r2)``: one V(nu1, nu2) cycle plus the
    Jacobi-equivalent residual (see module docstring).

    ``omega`` relaxes the red-black smoother (1.0 is the standard smoothing
    choice; over-relaxation trades smoothing for sweeping and is NOT the
    right default here, unlike the standalone sor2sma solver).

    ``maf``: variable-coefficient (metric) cycle.  Each level's operator is
    a MafCoeffs built from the COARSENED coordinate arrays
    (cz_maf.f90:68-101 metrics on the level's actual node spacings), the
    smoother is the MAF red-black sweep, and — because the metric operator
    carries its own 1/H^2 scaling — the restricted residual transfers with
    NO factor 4 (fine equation: dd*x - rp = b; defect: dd*e - rp(e) = r).
    The stopping residual is the omega=1 Jacobi-equivalent update r/dd.
    """
    from ..ops import maf as maf_ops

    coords = (grid.zc, grid.xc, grid.yc) if maf else None
    levels = build_levels(grid.shape_kij, grid.dtype, coords=coords)
    four = jnp.asarray(4.0, grid.dtype)
    r6 = jnp.asarray(1.0 / 6.0, grid.dtype)

    def residual(x, b, lv: _Level):
        if maf:
            ax = lv.mc.dd * x - lv.mc.nbr_weighted(x)  # no pvt: see below
            return (b - ax) * lv.msk
        return calc_rk(x, b, lv.msk)

    def smooth(x, b, lv: _Level, sweeps: int):
        for _ in range(sweeps):
            if maf:
                x, _ = maf_ops.sor2sma_maf_sweep(
                    x, b, lv.msk, omega, lv.mc, lv.cmasks
                )
            else:
                x, _ = stencil.sor2sma_sweep(x, b, lv.msk, omega, lv.cmasks)
        return x

    def vcycle(x, b, li: int):
        lv = levels[li]
        if li == len(levels) - 1:
            return smooth(x, b, lv, coarse_sweeps)
        x = smooth(x, b, lv, nu1)
        r = residual(x, b, lv)
        coarse = levels[li + 1]
        bc = restrict_fw(r, coarse.shape) * coarse.msk
        if not maf:
            bc = four * bc
        ec = vcycle(jnp.zeros(coarse.shape, x.dtype), bc, li + 1)
        x = x + prolong(ec, lv.shape) * lv.msk
        return smooth(x, b, lv, nu2)

    def step(x, b):
        x = vcycle(x, b, 0)
        lv0 = levels[0]
        r = residual(x, b, lv0)
        r = r / lv0.mc.dd if maf else r * r6
        return x, jnp.sum(r * r)

    if fmg:
        # per-level Dirichlet shells, injected down the hierarchy (module
        # docstring: FMG solves the true BVP at every level).  ``bc_shell``
        # overrides the uniform-cube analytic profile — the problem's own
        # Dirichlet data (e.g. the zero shell of a manufactured stretched
        # problem); default preserves the standard Laplace BVP.
        shell0 = grid.bc_field if bc_shell is None else bc_shell
        bcs = [shell0 * (1.0 - levels[0].msk)]
        for lv in levels[1:]:
            bcs.append(_inject_coarse(bcs[-1], lv.shape))

        def fmg_init(b):
            """One F-cycle from the RHS alone -> initial iterate with
            discretization-level error."""
            bl = b * levels[0].msk  # shell rows of the rhs are never read
            bs_ = [bl]
            for lv in levels[1:]:
                bl = restrict_fw(bl, lv.shape) * lv.msk
                if not maf:
                    bl = four * bl
                bs_.append(bl)
            li = len(levels) - 1
            x = bcs[li] + jnp.zeros(levels[li].shape, b.dtype)
            x = smooth(x, bs_[li], levels[li], coarse_sweeps)
            for li in range(len(levels) - 2, -1, -1):
                lv = levels[li]
                # trilinear interpolation of the full coarse solution —
                # the prolongation's end averages read the coarse shell,
                # so boundary data shapes the first fine layer correctly
                x = prolong(x, lv.shape) * lv.msk + bcs[li]
                x = vcycle(x, bs_[li], li)
            return x

        step.fmg_init = fmg_init

    # one "iteration" is a whole V-cycle: its cost dwarfs the convergence
    # check, and a default chunk of 16 would run up to 15 surplus cycles
    # on a solve that converges in ~6 (run_iterative consults this hint
    # for both solve() and solve_dist())
    step.check_every_default = 2
    return step
