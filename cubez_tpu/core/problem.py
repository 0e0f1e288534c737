"""Problem setup: fields + coefficient bundles for a solve.

Equivalent of the allocation/IC/BC phase of CZ::Evaluate
(cz_Evaluate.cpp:222-390) — grid, solution/RHS fields, inner mask, MAF metric
coefficients, and the pivot scaling used by MAF-BiCGSTAB.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

from .grid import Grid
from ..ops.maf import MafCoeffs


@dataclasses.dataclass(frozen=True)
class Problem:
    grid: Grid
    x0: jnp.ndarray
    rhs: jnp.ndarray
    msk: jnp.ndarray
    mc: Optional[MafCoeffs] = None
    pvt: Optional[jnp.ndarray] = None
    # True when rhs == 0 on every inner node (the reference Laplace problem):
    # lets the red-black kernel skip reading b entirely
    rhs_inner_zero: bool = False

    def rhs_is_inner_zero(self) -> bool:
        """The rhs_inner_zero hint, verified against the actual array.

        The stored flag survives ``dataclasses.replace(prob, rhs=...)``
        unchanged, so consumers that would *drop* the RHS (the kernel
        with ``b_is_zero``) must call this instead of trusting the field:
        one cheap device reduction guards against silently solving the
        wrong problem."""
        if not self.rhs_inner_zero:
            return False
        return not bool(jnp.any(self.rhs * self.msk))

    def msk_is_standard(self) -> bool:
        """True when msk is the standard cube inner mask (1 inside, 0 on
        the boundary shell) — the configuration whose steps synthesize
        the mask from iota in-trace instead of embedding an N^3 constant
        in the executable (536 MB at 512^3).

        Identity with ``grid.inner_mask`` (a cached_property) is the
        fast path; a replaced/resharded copy (e.g. solve_dist's
        ``cmesh.shard(problem.msk)``) is verified by two device-side
        scalar reductions — the count of entries equal to 1 is num_inner
        and the boundary shell's max |.| is 0, which pins the values
        exactly — rather than gathering N^3 elements to the host.  The
        count is taken in int32: a float32 sum of more than 2^24 ones is
        exact only if the reduction order happens to keep it so.  The
        reductions lower to collectives on sharded masks."""
        m = self.msk
        if m is self.grid.inner_mask:
            return True
        import jax

        faces = jnp.stack(
            [
                jnp.max(jnp.abs(f))
                for f in (m[0], m[-1], m[:, 0], m[:, -1],
                          m[:, :, 0], m[:, :, -1])
            ]
        )
        ones, bmax = jax.device_get(
            (jnp.sum(m == 1, dtype=jnp.int32), jnp.max(faces))
        )
        return int(ones) == self.grid.num_inner and float(bmax) == 0.0

    @classmethod
    def poisson_cube(cls, n, dtype=jnp.float32, maf: bool = False) -> "Problem":
        """The reference's only problem: Laplace on the unit cube with the
        sin*sin K-face Dirichlet profile (cz_Evaluate.cpp:15-18,374-390)."""
        if isinstance(n, int):
            n = (n, n, n)
        ni, nj, nk = n
        grid = Grid(ni=ni, nj=nj, nk=nk, dtype=dtype)
        mc = pvt = None
        if maf:
            mc = MafCoeffs.from_coords(grid.xc, grid.yc, grid.zc)
            pvt = mc.pivot()
        return cls(
            grid=grid,
            x0=grid.initial_p(),
            rhs=grid.initial_rhs(),
            msk=grid.inner_mask,
            mc=mc,
            pvt=pvt,
            rhs_inner_zero=True,
        )

    @classmethod
    def manufactured_stretched(
        cls, n, dtype=jnp.float64, family: str = "relax"
    ) -> tuple["Problem", jnp.ndarray]:
        """Manufactured-solution Poisson problem on genuinely stretched
        tensor-product coordinates — the discretization-level test the
        reference cannot run (its driver only ever fills uniform coords,
        cz_Evaluate.cpp:342-363, even though the MAF kernels accept any).

        Coordinates: tanh clustering in x/z (two different strengths) and a
        smooth sinusoidal perturbation in y — all smooth and monotone so the
        MAF metrics (cz_maf.f90:68-101) stay second-order accurate.  Exact
        solution u = sin(pi x) sin(pi y) sin(pi z) (zero on every face), so
        -lap(u) = 3 pi^2 u.

        ``family`` picks the RHS sign convention — the reference's MAF
        kernels are internally INCONSISTENT about it (invisible on its
        b == 0 benchmark, but decisive for any real source term):

        * "relax" (the point sweeps + mg_maf/fmg_maf/fd_maf): psor_maf /
          jacobi_maf / psor2sma_core_maf take ``rp + bb``
          (cz_maf.f90:94-105), so the fixed point is ``dd x - rp = b``,
          i.e. -L x = b with L the discrete Laplacian -> b = 3 pi^2 u.
        * "krylov" (the LINE solvers + BiCGSTAB): pcr_rb_maf/pcr_maf build
          the line RHS with ``- rhs`` (cz_maf.f90:558-566) and calc_rk_maf
          forms r = (b - L x) pvt (cz_blas.f90:810-818), so both solve
          L x = b -> b = -3 pi^2 u.

        (The constant-coefficient family is consistent: L x = b
        everywhere.)  Returns (problem, exact_field).
        """
        import numpy as np

        if isinstance(n, int):
            n = (n, n, n)
        ni, nj, nk = n

        def tanh_stretch(m, beta):
            t = np.linspace(0.0, 1.0, m)
            return 0.5 * (1.0 + np.tanh(beta * (2.0 * t - 1.0)) / np.tanh(beta))

        def sine_stretch(m, amp=0.08):
            t = np.linspace(0.0, 1.0, m)
            return t - amp * np.sin(2.0 * np.pi * t) / (2.0 * np.pi)

        xs = tanh_stretch(ni, 1.8)
        ys = sine_stretch(nj)
        zs = tanh_stretch(nk, 1.2)
        grid = Grid(
            ni=ni, nj=nj, nk=nk, dtype=dtype,
            coords_i=tuple(float(v) for v in xs),
            coords_j=tuple(float(v) for v in ys),
            coords_k=tuple(float(v) for v in zs),
        )
        mc = MafCoeffs.from_coords(grid.xc, grid.yc, grid.zc)

        u = (
            np.sin(np.pi * zs)[:, None, None]
            * np.sin(np.pi * xs)[None, :, None]
            * np.sin(np.pi * ys)[None, None, :]
        )
        b = 3.0 * np.pi**2 * u
        if family == "krylov":
            b = -b
        elif family != "relax":
            raise ValueError(f"unknown family {family!r}")
        msk = grid.inner_mask
        prob = cls(
            grid=grid,
            x0=jnp.zeros(grid.shape_kij, dtype=dtype),
            rhs=jnp.asarray(b, dtype=dtype) * msk,
            msk=msk,
            mc=mc,
            pvt=mc.pivot(),
            rhs_inner_zero=False,
        )
        return prob, jnp.asarray(u, dtype=dtype)
