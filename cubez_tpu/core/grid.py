"""Grid specification for the cube Poisson/Laplace problem.

JAX re-design of the reference's DomainInfo + allocation layer
(reference: src/cz_cpp/DomainInfo.h:27-139, cz_Evaluate.cpp:88,222-224,342-363).

Conventions
-----------
* Node-centered unit cube: node ``i`` (0-based) sits at ``x = i * pitch`` with
  ``pitch = 1 / (nk - 1)`` isotropic (reference cz_Evaluate.cpp:88).
* Array layout is ``(K, I, J)``: the tridiagonal line-solve axis K is the
  *major* axis so PCR stage shifts are cheap slices of whole planes, while
  J is the contiguous axis, so loads along J coalesce.  (The reference is
  also KIJ — src/cz_f90/cz_solver.f90:218 — for CPU-vectorization
  reasons.)
* No ghost/guide cells on a single device: the outermost node shell *is* the
  Dirichlet boundary data (the reference allocates GUIDE=2 but only ever
  exchanges/reads width 1 — cz_Define.h:40, cz_Poisson.cpp:63).
* The "inner" (updated) region is the 0-based slice ``[1, n-2]`` per axis on
  physical boundaries — the 1-based ``[2, N-1]`` of cz_miscel.cpp:20-52.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """Global cube grid of nodes.

    Attributes:
      ni, nj, nk: global node counts along I(x), J(y), K(z).
      dtype: field dtype (float32 like the reference default REAL_TYPE, or
        float64 for ``-D_REAL_IS_DOUBLE_`` parity — cz_Define.h:28-37).
    """

    ni: int
    nj: int
    nk: int
    dtype: jnp.dtype = jnp.float32
    # Optional custom node coordinates (stretched grids) as tuples of floats
    # — tuples keep the dataclass hashable.  When set, xc/yc/zc return these
    # instead of the uniform i*pitch nodes, and everything that derives
    # operators from coordinates (MafCoeffs, the mg_maf level hierarchy)
    # follows.  bc_field/exact/max_error remain the UNIFORM-cube analytic
    # problem (cz_utility.f90:52-129) and are not meaningful on a custom
    # grid — stretched-grid problems carry their own exact fields
    # (Problem.manufactured_stretched).
    coords_i: tuple | None = None
    coords_j: tuple | None = None
    coords_k: tuple | None = None

    @property
    def shape_kij(self) -> tuple[int, int, int]:
        return (self.nk, self.ni, self.nj)

    @property
    def pitch(self) -> float:
        # Isotropic, referenced to the K extent (cz_Evaluate.cpp:88).
        return 1.0 / float(self.nk - 1)

    @property
    def num_inner(self) -> int:
        # (N-2)^3 inner nodes on a physical-boundary cube (cz_miscel.cpp:20-52).
        return (self.ni - 2) * (self.nj - 2) * (self.nk - 2)

    @property
    def res_normal(self) -> float:
        # 1 / (global inner point count) (cz_Evaluate.cpp:222-224).
        return 1.0 / float(self.num_inner)

    # --- coordinates -------------------------------------------------------

    def coords(self, axis: str) -> jnp.ndarray:
        """Node coordinates along 'i' | 'j' | 'k', shape (n,)."""
        custom = {"i": self.coords_i, "j": self.coords_j, "k": self.coords_k}[axis]
        if custom is not None:
            return jnp.asarray(custom, dtype=self.dtype)
        n = {"i": self.ni, "j": self.nj, "k": self.nk}[axis]
        return (jnp.arange(n, dtype=self.dtype) * self.dtype_(self.pitch)).astype(
            self.dtype
        )

    def dtype_(self, v):
        return jnp.asarray(v, dtype=self.dtype)

    @cached_property
    def xc(self) -> jnp.ndarray:
        return self.coords("i")

    @cached_property
    def yc(self) -> jnp.ndarray:
        return self.coords("j")

    @cached_property
    def zc(self) -> jnp.ndarray:
        return self.coords("k")

    # --- masks / regions ---------------------------------------------------

    @cached_property
    def inner_mask(self) -> jnp.ndarray:
        """1.0 on updated (inner) nodes, 0.0 on the boundary shell.

        Equivalent of imask_k (cz_blas.f90:24-103).
        """
        m = np.zeros(self.shape_kij, dtype=np.float64)
        m[1:-1, 1:-1, 1:-1] = 1.0
        return jnp.asarray(m, dtype=self.dtype)

    @property
    def inner_slices(self) -> tuple[slice, slice, slice]:
        return (slice(1, self.nk - 1), slice(1, self.ni - 1), slice(1, self.nj - 1))

    # --- boundary / analytic fields ----------------------------------------

    @cached_property
    def bc_field(self) -> jnp.ndarray:
        """Dirichlet boundary values on the shell, 0 in the interior.

        sin(pi x) sin(pi y) on the two K faces, 0 on the four side walls;
        side walls overwrite face edges (bc_k, cz_solver.f90:22-191).
        """
        x = np.arange(self.ni) * self.pitch
        y = np.arange(self.nj) * self.pitch
        sinsin = np.outer(np.sin(np.pi * x), np.sin(np.pi * y))  # (I, J)
        f = np.zeros(self.shape_kij, dtype=np.float64)
        f[0, :, :] = sinsin
        f[-1, :, :] = sinsin
        # side walls (applied after the K faces, same order as bc_k)
        f[:, 0, :] = 0.0
        f[:, -1, :] = 0.0
        f[:, :, 0] = 0.0
        f[:, :, -1] = 0.0
        return jnp.asarray(f, dtype=self.dtype)

    def apply_bc(self, p: jnp.ndarray) -> jnp.ndarray:
        """Re-impose Dirichlet data on the boundary shell (bc_k_ call sites,
        e.g. cz_Poisson.cpp:74)."""
        return jnp.where(self.inner_mask > 0, p, self.bc_field)

    @cached_property
    def exact(self) -> jnp.ndarray:
        """Separable analytic solution of the Laplace problem
        (exact_t, cz_utility.f90:52-82)::

            sin(pi x) sin(pi y) / sinh(sqrt2 pi)
              * ( sinh(sqrt2 pi z) - sinh(sqrt2 pi (z-1)) )
        """
        x = np.arange(self.ni) * self.pitch
        y = np.arange(self.nj) * self.pitch
        z = np.arange(self.nk) * self.pitch
        r2pi = math.sqrt(2.0) * np.pi
        sinsin = np.outer(np.sin(np.pi * x), np.sin(np.pi * y))  # (I, J)
        kprof = (np.sinh(r2pi * z) - np.sinh(r2pi * (z - 1.0))) / math.sinh(r2pi)
        e = kprof[:, None, None] * sinsin[None, :, :]
        return jnp.asarray(e, dtype=self.dtype)

    # --- initial fields -----------------------------------------------------

    def initial_p(self) -> jnp.ndarray:
        """Zero field with BC applied (cz_Evaluate.cpp:374-378)."""
        return self.bc_field

    def initial_rhs(self) -> jnp.ndarray:
        """RHS: zero source; the reference also writes the BC profile onto the
        RHS boundary planes (cz_Evaluate.cpp:381-386) but those nodes are never
        read by any kernel, so we replicate for byte-parity of the field."""
        return self.bc_field


def max_error(grid: Grid, p: jnp.ndarray) -> float:
    """Max |p - exact| over inner nodes (err_t, cz_utility.f90:86-129)."""
    d = jnp.abs(p - grid.exact) * grid.inner_mask
    return float(jnp.max(d))


def max_error_loc(grid: Grid, p: jnp.ndarray) -> tuple[float, tuple[int, int, int]]:
    """(max |p - exact|, argmax (i, j, k) 1-based) — the full err_t output
    the driver prints as 'Error max = %e at (i j k)'
    (cz_Evaluate.cpp:550-563)."""
    d = jnp.abs(p - grid.exact) * grid.inner_mask
    flat = int(jnp.argmax(d))
    k, i, j = np.unravel_index(flat, grid.shape_kij)
    return float(jnp.max(d)), (int(i) + 1, int(j) + 1, int(k) + 1)
