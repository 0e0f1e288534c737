"""Per-iteration step builders for every solver family.

A step is a pure function ``step(x, b) -> (x_new, r2_sum)`` closing over the
problem's static data (masks, metric tables, PCR plans).  The outer drivers
(driver.py, bicgstab.py) own convergence logic; the BiCGSTAB preconditioner
reuses the same steps with a different ``b`` (cz_Poisson.cpp:273-322).

Solver-name parity with the reference CLI (cz_Evaluate.cpp:684-803):
  jacobi, psor, sor2sma, pcr, pcr_eda, pcr_esa, pcr_rb, pcr_rb_esa,
  pcr_j_esa, pbicgstab (+ ``_maf`` for each except pcr_j_esa).
pcr / pcr_eda / pcr_esa are the same serial line-Gauss-Seidel math in three
memory layouts (identical histories per doc/Memo.md:134) and resolve to one
wavefront-exact step; pcr_j_esa is the Jacobi-update form and resolves to
the line-Jacobi step; pcr_rb[_esa] resolve to the red-black line step.  See _CANON below for the evidence.
"""

from __future__ import annotations


import jax.numpy as jnp

from ..core.problem import Problem
from ..ops import maf as maf_ops
from ..ops import pcr as pcr_ops
from ..ops import stencil

# canonical kind per CLI solver name.
#
# The reference's pcr / pcr_eda / pcr_esa relax each line IN PLACE inside the
# lexicographic (j,i) loop (cz_solver.f90:848-856), so their serial (= only
# deterministic) semantics is line-GAUSS-SEIDEL — stable at the documented
# omega=1.5 (Readme.md:390).  Only pcr_j_esa is the Jacobi-update form
# (source snapshot into src, result into wrk; cz_solver.f90:1521-1531), and
# line-Jacobi requires omega <~ 1.0 (verified with the serial oracle,
# tools/ref_oracle.cpp: diverges at 1.1).  Kinds:
#   pcr_gs — wavefront line-Gauss-Seidel, exactly the serial reference pcr
#   pcr    — line-Jacobi full-plane pass (reference pcr_j_esa)
#   pcr_rb — red-black line relaxation (deterministic AND fast; same
#            iteration counts as pcr_gs: 142 vs 140 at 32^3 omega=1.5)
_CANON = {
    "jacobi": "jacobi",
    "psor": "psor",
    "sor2sma": "sor2sma",
    "pcr": "pcr_gs",
    "pcr_eda": "pcr_gs",
    "pcr_esa": "pcr_gs",
    "pcr_j_esa": "pcr",
    "pcr_rb": "pcr_rb",
    "pcr_rb_esa": "pcr_rb",
}

RELAX_SOLVERS = tuple(_CANON)
ALL_SOLVERS = RELAX_SOLVERS + tuple(
    f"{k}_maf" for k in _CANON if k != "pcr_j_esa"
) + ("pbicgstab", "pbicgstab_maf")
# beyond-reference extensions (documented in README); kept out of
# ALL_SOLVERS, which is the reference-parity registry
EXTENSION_SOLVERS = ("mg", "mg_maf", "fmg", "fmg_maf", "fd", "fd_maf", "cg")


def parse_name(name: str):
    n = name.lower()
    is_maf = n.endswith("_maf")
    base = n[: -len("_maf")] if is_maf else n
    if base == "pbicgstab":
        return "pbicgstab", is_maf
    if base == "cg":
        return "cg", is_maf
    if base in ("mg", "fmg", "fd"):
        return base, is_maf
    if base not in _CANON:
        raise ValueError(
            f"unknown solver '{name}' (known: "
            f"{', '.join(ALL_SOLVERS + EXTENSION_SOLVERS)})"
        )
    return _CANON[base], is_maf


def _named(label, fn):
    """Tag the step's ops for profiler traces — the NVTX/FAPP-range
    equivalent (PUSH_RANGE/POP_RANGE, cz.h:46-74; fapp_start, cz.h:513).
    Step attributes (iters_per_call, check_every_default, ...) carry
    through: the drivers consult them on whatever callable they receive."""
    import functools

    import jax

    @functools.wraps(fn)
    def wrapped(*args):
        with jax.named_scope(label):
            return fn(*args)

    return wrapped


def _require_standard_mask(problem: Problem, name: str):
    """Raise unless problem.msk is the standard cube inner mask
    (Problem.msk_is_standard: identity fast path + device-side scalar
    verification for replaced/resharded copies)."""
    if not problem.msk_is_standard():
        raise ValueError(
            f"{name} supports the standard cube inner mask only"
        )


def make_step(problem: Problem, name: str, omega: float, color_offset: int = 0):
    """Build step(x, b) -> (x_new, r2) for any relaxation/line solver.

    Steps are wrapped in a jax.named_scope with the solver name so device
    profiles group per-solver kernels like the reference's PMlib labels."""
    step = _named(name, _make_step(problem, name, omega, color_offset))
    kind, _ = parse_name(name)
    if kind in ("psor", "pcr_gs"):
        # wavefront-exact sweeps cost O(N) sequential passes each — the
        # convergence-check overhead the chunked loop amortizes is noise
        # next to one sweep, so check every iteration (also keeps rate
        # runs from executing surplus sweeps past itr_max)
        step.check_every_default = 1
    return step


def _make_step(problem: Problem, name: str, omega: float, color_offset: int = 0):
    kind, is_maf = parse_name(name)
    if kind == "pbicgstab":
        raise ValueError("pbicgstab is a driver, not a sweep; see bicgstab.py")
    if kind == "cg":
        raise ValueError("cg is a driver, not a sweep; see cg.py")

    g = problem.grid
    msk = problem.msk
    dtype = g.dtype
    nk = g.nk
    kst, ked = 1, nk - 2  # 0-based inner K range

    if is_maf and problem.mc is None:
        raise ValueError("MAF solver requested but Problem has no MafCoeffs")
    mc = problem.mc

    if kind == "fd":
        from .direct import make_fd_step

        # the fast-diagonalization operator is the separable cube
        # operator: a non-standard mask (obstacle/void nodes) breaks
        # separability — reject instead of solving the wrong problem
        _require_standard_mask(problem, "fd")
        return make_fd_step(problem, maf=is_maf)

    if kind in ("mg", "fmg"):
        import numpy as np

        from .multigrid import make_mg_step

        # the V-cycle builds its own level masks from the grid alone; a
        # Problem carrying a non-standard mask (obstacle/void nodes) would
        # silently solve the unmasked problem — coarsening such masks is
        # out of scope, so reject instead
        _require_standard_mask(problem, "mg")
        if is_maf:
            # the level hierarchy derives its operators from the grid's
            # coordinate arrays; a Problem carrying coefficients from OTHER
            # coords would get the wrong coarse operators
            ref = type(mc).from_coords(g.xc, g.yc, g.zc)
            if not all(
                np.array_equal(np.asarray(getattr(mc, f)),
                               np.asarray(getattr(ref, f)))
                for f in ("c1", "c7", "c2", "c8", "c3", "c9")
            ):
                raise ValueError(
                    "mg_maf requires MafCoeffs built from the grid's own "
                    "coordinate arrays"
                )
        return make_mg_step(
            g, omega=omega,
            maf=is_maf,
            fmg=(kind == "fmg"),
            # FMG imposes the PROBLEM's Dirichlet shell at every level
            # (x0's boundary ring; == grid.bc_field for the standard cube)
            bc_shell=(problem.x0 * (1.0 - problem.msk))
            if kind == "fmg" else None,
        )

    # Standard-mask problems synthesize the inner mask from iota INSIDE
    # the step: a closed-over (K, I, J) mask array is embedded in the
    # jitted executable as a constant (536 MB at 512^3, and an extra
    # device-memory stream besides); the iota
    # form has identical values, so results are bitwise unchanged.
    # Color masks depend only on the shape and always use the iota form.
    # msk_is_standard (not identity alone) so resharded copies of the
    # standard mask — e.g. solve_dist's auto-SPMD fallback builds
    # msk=cmesh.shard(problem.msk) — still synthesize instead of embed.
    if problem.msk_is_standard():
        mskf = lambda: stencil.inner_mask_expr(g.shape_kij, dtype)  # noqa: E731
    else:
        mskf = lambda: msk  # noqa: E731

    if kind == "jacobi":
        if is_maf:
            return lambda x, b: maf_ops.jacobi_maf_sweep(x, b, mskf(), omega,
                                                         mc)
        return lambda x, b: stencil.jacobi_sweep(x, b, mskf(), omega)

    if kind == "psor":
        # diagonal-plane affine-scan Gauss-Seidel: same serial dependency
        # order as the reference psor/psor_maf, O(N^3) per sweep (see
        # ops/psor_scan.py; the O(N^4) hyperplane-masked form it replaces
        # stays in ops/stencil.py::psor_sweep as the bitwise-exact oracle
        # for tests).  Requires an all-ones inner mask: the skewed scan
        # would propagate THROUGH interior masked-off nodes.
        from ..ops import psor_scan

        _require_standard_mask(problem, "psor")
        return psor_scan.make_psor_diag_step(
            g.shape_kij, dtype, omega, mc=mc if is_maf else None
        )

    if kind == "sor2sma":
        def cmasksf():
            return stencil.color_masks_expr(
                g.shape_kij, offset=color_offset, dtype=dtype
            )

        if is_maf:
            return lambda x, b: maf_ops.sor2sma_maf_sweep(
                x, b, mskf(), omega, mc, cmasksf()
            )
        return lambda x, b: stencil.sor2sma_sweep(x, b, mskf(), omega,
                                                  cmasksf())

    # ---- line solvers -------------------------------------------------------
    n = ked - kst + 1
    om = jnp.asarray(omega, dtype)
    msk_in = msk[kst : ked + 1]

    if kind == "pcr":
        if is_maf:
            pn = pcr_ops.num_stage(n)

            def pcr_maf_step(x, b):
                a, c, d = pcr_ops.build_line_system_maf(x, b, msk, mc, kst, ked)
                sol = pcr_ops.pcr_reduce_var(a, c, d, pn)
                dp = (sol - x[kst : ked + 1]) * om * msk_in
                return x.at[kst : ked + 1].add(dp), jnp.sum(dp * dp)

            return pcr_maf_step

        plan = pcr_ops.build_pcr_plan(n, dtype)

        def pcr_step(x, b):
            d = pcr_ops.build_line_rhs(x, b, msk, kst, ked)
            sol = pcr_ops.pcr_reduce_const(d, plan)
            dp = (sol - x[kst : ked + 1]) * om * msk_in
            return x.at[kst : ked + 1].add(dp), jnp.sum(dp * dp)

        return pcr_step

    if kind == "pcr_gs":
        # Exact line-Gauss-Seidel via diagonal wavefront: lexicographic
        # line-GS at line (i,j) reads updated (i-1,j),(i,j-1) — both on
        # diagonal i+j-1 — and old (i+1,j),(i,j+1) on diagonal i+j+1, so
        # sweeping diagonals d = i+j in order reproduces the serial
        # reference pcr (cz_solver.f90:848-856) exactly.  Each diagonal
        # solves ONLY its own lines through the production PCR stage
        # tables in the skewed layout (ops/pcr_gs.py) — O(N^3 log N) per
        # sweep.  Requires the standard all-ones inner mask (the skewed
        # per-diagonal solve drops the per-node msk factors).
        from ..ops import pcr_gs

        _require_standard_mask(problem, "pcr")
        return pcr_gs.make_pcr_gs_diag_step(
            g.shape_kij, dtype, omega, mc=mc if is_maf else None,
            kst=kst, ked=ked,
        )

    if kind == "pcr_rb":
        lmasks = pcr_ops.line_color_masks(g.ni, g.nj, color_offset, dtype)
        if is_maf:
            pn = pcr_ops.num_stage(n)

            def pcr_rb_maf_step(x, b):
                r2 = jnp.zeros((), dtype)
                for color in (0, 1):
                    a, c, d = pcr_ops.build_line_system_maf(
                        x, b, msk, mc, kst, ked
                    )
                    sol = pcr_ops.pcr_reduce_var(a, c, d, pn)
                    dp = (sol - x[kst : ked + 1]) * om * msk_in * lmasks[color]
                    x = x.at[kst : ked + 1].add(dp)
                    r2 = r2 + jnp.sum(dp * dp)
                return x, r2

            return pcr_rb_maf_step

        plan = pcr_ops.build_pcr_plan(n, dtype)

        def pcr_rb_step(x, b):
            r2 = jnp.zeros((), dtype)
            for color in (0, 1):
                d = pcr_ops.build_line_rhs(x, b, msk, kst, ked)
                sol = pcr_ops.pcr_reduce_const(d, plan)
                dp = (sol - x[kst : ked + 1]) * om * msk_in * lmasks[color]
                x = x.at[kst : ked + 1].add(dp)
                r2 = r2 + jnp.sum(dp * dp)
            return x, r2

        return pcr_rb_step

    raise AssertionError(kind)
