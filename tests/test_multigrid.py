"""Geometric multigrid (solvers/multigrid.py — beyond-reference extension).

Pinned properties: textbook V-cycle behavior (grid-size-independent cycle
counts, ~0.25 contraction), transfer-operator adjointness (catches any
index-plumbing error in the strided restriction/prolongation), arbitrary
grid sizes (the reference sizes are not 2^k+1), serial-vs-distributed
exactness through the auto-SPMD path, and the one-V-cycle BiCGSTAB
preconditioner.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cubez_tpu import Problem, max_error, solve
from cubez_tpu.solvers import multigrid as mg


# ---- transfer operators ----------------------------------------------------


@pytest.mark.parametrize("fine", [(11, 12, 13), (18, 18, 18), (33, 17, 24)])
def test_restrict_prolong_adjoint(fine):
    """Full-weighting restriction is the prolongation transpose / 8
    (R = P^T / 2 per axis), for even AND odd inner extents."""
    levels = mg.build_levels(fine, jnp.float32)
    assert len(levels) >= 2
    coarse = levels[1].shape
    rng = np.random.RandomState(0)

    r = np.zeros(fine, np.float32)
    r[1:-1, 1:-1, 1:-1] = rng.randn(*[s - 2 for s in fine])
    ec = np.zeros(coarse, np.float32)
    ec[1:-1, 1:-1, 1:-1] = rng.randn(*[s - 2 for s in coarse])

    a = float(jnp.sum(mg.prolong(jnp.asarray(ec), fine) * r))
    b = float(jnp.sum(jnp.asarray(ec) * mg.restrict_fw(jnp.asarray(r), coarse)))
    assert a == pytest.approx(8.0 * b, rel=1e-5)


def test_prolong_exact_on_coarse_points():
    """Fine points that coincide with coarse points receive the coarse
    value exactly; odd points the mean of their two coarse neighbours."""
    fine = (10, 10, 10)  # inner 8 -> coarse inner 4
    coarse = (6, 6, 6)
    ec = np.zeros(coarse, np.float32)
    ec[1:-1, 1:-1, 1:-1] = np.arange(64, dtype=np.float32).reshape(4, 4, 4)
    ef = np.asarray(mg.prolong(jnp.asarray(ec), fine))
    for c in range(1, 5):
        # (2c, 2, 4) is a coarse point on every axis -> injected exactly
        assert ef[2 * c, 2, 4] == pytest.approx(ec[c, 1, 2])
        # odd J index between coarse 2 and 3
        assert ef[2 * c, 2, 5] == pytest.approx(
            0.5 * (ec[c, 1, 2] + ec[c, 1, 3])
        )
    # odd fine index between coarse 1 and 2 along axis 0
    assert ef[3, 2, 2] == pytest.approx(0.5 * (ec[1, 1, 1] + ec[2, 1, 1]))
    # zero shell holds even when the inner extent is even (the last odd
    # interpolant would otherwise land on the wall index)
    for face in (ef[0], ef[-1], ef[:, 0], ef[:, -1], ef[:, :, 0],
                 ef[:, :, -1]):
        assert np.abs(face).max() == 0.0


def test_mg_custom_mask_rejected():
    import dataclasses

    prob = Problem.poisson_cube(16)
    bad = prob.msk.at[8, 8, 8].set(0.0)
    with pytest.raises(ValueError, match="mask"):
        solve(dataclasses.replace(prob, msk=bad), "mg", 1.0, 10)


def test_mg_step_carries_check_every_hint():
    from cubez_tpu.solvers.steps import make_step

    step = make_step(Problem.poisson_cube(16), "mg", 1.0)
    assert step.check_every_default == 2  # survives the named_scope wrapper


# ---- V-cycle convergence ---------------------------------------------------


@pytest.mark.parametrize("shape", [32, 33, (24, 32, 40)])
def test_mg_converges_fast_any_size(shape):
    prob = Problem.poisson_cube(shape)
    r = solve(prob, "mg", omega=1.0, itr_max=50)
    assert r.iters <= 10  # measured: 6 cycles at every size
    assert r.res < 1.0e-5


def test_mg_grid_independent_cycles_and_contraction():
    iters = {}
    for n in (32, 64):
        prob = Problem.poisson_cube(n)
        r = solve(prob, "mg", omega=1.0, itr_max=50, eps=1e-6)
        iters[n] = r.iters
        h = np.asarray(r.history)
        ratios = h[1:] / h[:-1]
        assert np.all(ratios < 0.45), ratios  # measured ~0.25 per V(1,1)
    assert abs(iters[32] - iters[64]) <= 2  # size-independent


def test_mg_solution_accuracy():
    """MG drives the true residual, so the analytic error reaches the
    discretization level — better than the update-criterion relaxation
    solvers at the same eps (sor2sma leaves 3.5e-3 at 64^3)."""
    prob = Problem.poisson_cube(64)
    r = solve(prob, "mg", omega=1.0, itr_max=50)
    assert max_error(prob.grid, r.x) < 1.0e-3  # measured 1.96e-4


def test_mg_eps_1e6():
    prob = Problem.poisson_cube(32)
    r = solve(prob, "mg", omega=1.0, itr_max=50, eps=1e-6)
    assert r.res < 1e-6 and r.iters <= 12


def test_mg_history_semantics(tmp_path):
    prob = Problem.poisson_cube(24)
    p = tmp_path / "mg.txt"
    r = solve(prob, "mg", omega=1.0, itr_max=50, history_path=str(p))
    lines = p.read_text().splitlines()
    assert lines[0].startswith("Itration")
    assert len(lines) == r.iters + 1


@pytest.mark.parametrize("shape", [32, 33])
def test_mg_maf_converges_fast(shape):
    """Variable-coefficient cycle: per-level MafCoeffs from the coarsened
    coordinates, residual transfer WITHOUT the factor 4 (the metric
    operator carries its own 1/H^2)."""
    prob = Problem.poisson_cube(shape, maf=True)
    r = solve(prob, "mg_maf", omega=1.0, itr_max=50)
    assert r.iters <= 10  # measured: 5-6 cycles
    assert r.res < 1.0e-5
    assert max_error(prob.grid, r.x) < 1.5e-3


def test_bicgstab_mg_maf_precond():
    prob = Problem.poisson_cube(32, maf=True)
    r = solve(prob, "pbicgstab_maf", omega=1.1, itr_max=50, precond="mg_maf")
    # ONE V-cycle per application (not the reference's fixed 8 sweeps —
    # 8 V-cycles would be an essentially exact inverse and hide bugs
    # behind 1-iteration convergence)
    assert 2 <= r.iters <= 5
    assert r.res < 1e-5


def test_mg_maf_foreign_coeffs_rejected():
    import dataclasses

    from cubez_tpu.ops.maf import MafCoeffs

    prob = Problem.poisson_cube(16, maf=True)
    g = prob.grid
    alien = MafCoeffs.from_coords(g.xc * 2.0, g.yc, g.zc)
    with pytest.raises(ValueError, match="coordinate"):
        solve(dataclasses.replace(prob, mc=alien), "mg_maf", 1.0, 10)


# ---- full multigrid (F-cycle initializer) ----------------------------------


@pytest.mark.parametrize("n", [33, 48])  # odd AND even inner extents
def test_fmg_beats_mg_to_tolerance(n):
    """One F-cycle start -> the driver stops in <= 3 V-cycles (mg needs
    ~6), at the same discretization-error floor.  Covers both coarsening
    geometries (even fine extents take the boundary-local inconsistency
    path, module docstring)."""
    prob = Problem.poisson_cube(n)
    rf = solve(prob, "fmg", omega=1.0, itr_max=20)
    rm = solve(prob, "mg", omega=1.0, itr_max=50)
    assert rf.res < 1e-5
    assert rf.iters <= 3
    assert rf.iters < rm.iters
    assert max_error(prob.grid, rf.x) <= 1.2 * max_error(prob.grid, rm.x)


def test_fmg_init_alone_reaches_discretization_error():
    """The F-cycle by itself (before any driver V-cycle) sits within a
    small constant of the discretization-error floor — the defining FMG
    property (measured 3.2x here with V(1,1) per level; the driver's
    first V-cycle closes the rest, see test_fmg_beats_mg_to_tolerance).
    The factor-100 margin over a single V-cycle from zero (1.6e-2)
    is what the test actually pins."""
    from cubez_tpu.solvers.steps import make_step

    prob = Problem.poisson_cube(33)
    step = make_step(prob, "fmg", 1.0)
    x = jax.jit(step.fmg_init)(prob.rhs)
    rm = solve(prob, "mg", omega=1.0, itr_max=50)
    assert max_error(prob.grid, x) <= 4.0 * max_error(prob.grid, rm.x)


def test_fmg_rejects_custom_x0():
    """The F-cycle derives its own initial iterate and would silently
    discard a caller's x0 (checkpoint restart, custom shell) — reject it
    and point at mg."""
    import dataclasses

    prob = Problem.poisson_cube(24)
    warm = dataclasses.replace(prob, x0=prob.x0 + 0.5 * prob.msk)
    with pytest.raises(ValueError, match="discard"):
        solve(warm, "fmg", omega=1.0, itr_max=5)
    # mg accepts the same problem
    r = solve(warm, "mg", omega=1.0, itr_max=50)
    assert r.res < 1e-5


def test_fmg_as_precond_maps_to_one_vcycle():
    """precond='fmg' means the same thing as precond='mg' (the F-cycle is
    a solve-level initializer, affine in b — not a linear operator), so
    the Krylov iteration counts must match exactly."""
    prob = Problem.poisson_cube(32)
    ra = solve(prob, "pbicgstab", omega=1.1, itr_max=50, precond="mg")
    rb = solve(prob, "pbicgstab", omega=1.1, itr_max=50, precond="fmg")
    assert rb.iters == ra.iters
    assert rb.res == ra.res


def test_fmg_maf():
    prob = Problem.poisson_cube(32, maf=True)
    rf = solve(prob, "fmg_maf", omega=1.0, itr_max=20)
    rm = solve(prob, "mg_maf", omega=1.0, itr_max=50)
    assert rf.res < 1e-5
    assert rf.iters < rm.iters
    assert max_error(prob.grid, rf.x) <= 1.2 * max_error(prob.grid, rm.x)


# ---- distributed -----------------------------------------------------------


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_mg_dist_matches_serial():
    """mg distributes through the auto-SPMD fallback (pure jnp V-cycle on
    sharded arrays).  GSPMD may regroup reduction arithmetic when coarse
    extents shard unevenly (24^3 coarsens to 13-wide levels), so the
    guarantee is identical iteration counts/residuals and agreement inside
    the algebraic-error ball at the stopping residual — not bitwise fields
    (the explicit shard_map solvers DO pin bitwise; see test_parallel)."""
    from cubez_tpu.parallel import make_mesh, solve_dist

    prob = Problem.poisson_cube(24)
    cm = make_mesh(prob.grid.shape_kij)
    rd = solve_dist(prob, cm, "mg", omega=1.0, itr_max=50)
    rs = solve(prob, "mg", omega=1.0, itr_max=50)
    assert rd.iters == rs.iters
    assert rd.res == pytest.approx(rs.res, rel=1e-4)
    assert np.abs(np.asarray(rd.x) - np.asarray(rs.x)).max() < 1e-3


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_fmg_dist_matches_serial():
    """fmg distributes like mg (the F-cycle initializer is pure jnp, so
    GSPMD shards it with the rest of the auto-SPMD fallback)."""
    from cubez_tpu.parallel import make_mesh, solve_dist

    prob = Problem.poisson_cube(24)
    cm = make_mesh(prob.grid.shape_kij)
    rd = solve_dist(prob, cm, "fmg", omega=1.0, itr_max=20)
    rs = solve(prob, "fmg", omega=1.0, itr_max=20)
    assert rd.iters == rs.iters
    assert rd.res == pytest.approx(rs.res, rel=1e-4)
    assert np.abs(np.asarray(rd.x) - np.asarray(rs.x)).max() < 1e-3


# ---- as a preconditioner ---------------------------------------------------


def test_bicgstab_mg_precond():
    prob = Problem.poisson_cube(32)
    r = solve(prob, "pbicgstab", omega=1.1, itr_max=50, precond="mg")
    assert r.iters <= 5  # measured 3 at 64^3
    assert r.res < 1e-5
    assert max_error(prob.grid, r.x) < 1.5e-3
