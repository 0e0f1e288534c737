"""Multi-device tests on the 8-virtual-CPU mesh: decomposition search, halo
exchange, and serial-vs-distributed solver equivalence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cubez_tpu import Problem, solve
from cubez_tpu.parallel.decomp import auto_division
from cubez_tpu.parallel.dist import make_dist_step
from cubez_tpu.parallel.mesh import make_mesh
from cubez_tpu.solvers import steps as steps_mod
from cubez_tpu.solvers.driver import run_iterative


def cpu8():
    d = jax.devices("cpu")
    assert len(d) >= 8, "tests need --xla_force_host_platform_device_count=8"
    return d[:8]


def test_auto_division_cube():
    assert auto_division(8, (64, 64, 64)) == (2, 2, 2)
    assert auto_division(1, (64, 64, 64)) == (1, 1, 1)
    dz, dx, dy = auto_division(4, (64, 64, 64))
    assert dz * dx * dy == 4 and max(dz, dx, dy) == 2


def test_auto_division_flat_grid():
    # grid short along K: prefer not to split K
    d = auto_division(8, (8, 256, 256))
    assert d[0] <= 2
    assert np.prod(d) == 8


@pytest.mark.parametrize("div", [(2, 2, 2), (1, 2, 4), (1, 1, 8), (8, 1, 1)])
def test_dist_jacobi_matches_serial(div):
    n = 32
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=cpu8(), div=div)

    serial_step = steps_mod.make_step(prob, "jacobi", 0.8)
    dist_step = make_dist_step(prob, cm, "jacobi", 0.8)

    x_s = prob.x0
    x_d = cm.shard(prob.x0)
    b_d = cm.shard(prob.rhs)
    for _ in range(5):
        x_s, r_s = serial_step(x_s, prob.rhs)
        x_d, r_d = dist_step(x_d, b_d)
    np.testing.assert_allclose(np.asarray(x_d), np.asarray(x_s), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(float(r_d), float(r_s), rtol=1e-5)


def test_dist_sor2sma_matches_serial():
    # per-color halo exchange makes the distributed sweep serial-equivalent
    n = 32
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=cpu8(), div=(2, 2, 2))
    serial_step = steps_mod.make_step(prob, "sor2sma", 1.5)
    dist_step = make_dist_step(prob, cm, "sor2sma", 1.5)
    x_s, x_d, b_d = prob.x0, cm.shard(prob.x0), cm.shard(prob.rhs)
    for _ in range(5):
        x_s, r_s = serial_step(x_s, prob.rhs)
        x_d, r_d = dist_step(x_d, b_d)
    np.testing.assert_allclose(np.asarray(x_d), np.asarray(x_s), rtol=2e-5, atol=1e-6)


def test_dist_pcr_unsplit_k_matches_serial():
    # with the K axis unsplit, block-local lines are full lines: distributed
    # pcr must reproduce the serial line-Jacobi sweep
    n = 32
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=cpu8(), div=(1, 2, 4))
    serial_step = steps_mod.make_step(prob, "pcr_j_esa", 1.0)
    dist_step = make_dist_step(prob, cm, "pcr_j_esa", 1.0)
    x_s, x_d, b_d = prob.x0, cm.shard(prob.x0), cm.shard(prob.rhs)
    for _ in range(3):
        x_s, r_s = serial_step(x_s, prob.rhs)
        x_d, r_d = dist_step(x_d, b_d)
    np.testing.assert_allclose(np.asarray(x_d), np.asarray(x_s), rtol=3e-5, atol=1e-6)


def test_dist_pcr_split_k_converges():
    # K split across 2 blocks: block-local line solves (reference multi-rank
    # semantics) still converge to the analytic solution
    from cubez_tpu import max_error

    n = 32
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=cpu8(), div=(2, 2, 2))
    step = make_dist_step(prob, cm, "pcr_rb", 1.5)
    res = run_iterative(
        step, cm.shard(prob.x0), cm.shard(prob.rhs), prob.grid.res_normal,
        itr_max=20000,
    )
    assert res.res < 1e-5
    assert max_error(prob.grid, res.x) < 1e-2


def test_auto_spmd_path():
    # serial solver code on sharded arrays: XLA partitions it automatically
    n = 32
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=cpu8(), div=(2, 2, 2))
    import dataclasses

    prob_sharded = dataclasses.replace(
        prob, x0=cm.shard(prob.x0), rhs=cm.shard(prob.rhs), msk=cm.shard(prob.msk)
    )
    r_d = solve(prob_sharded, "sor2sma", omega=1.5, itr_max=3000)
    r_s = solve(prob, "sor2sma", omega=1.5, itr_max=3000)
    assert r_d.iters == r_s.iters
    np.testing.assert_allclose(r_d.history, r_s.history, rtol=1e-4)


@pytest.mark.parametrize("name", ["jacobi_maf", "sor2sma_maf"])
def test_dist_maf_matches_serial(name):
    # explicit sharded MAF sweeps: metric tables dynamic-sliced per block
    n = 16
    prob = Problem.poisson_cube(n, dtype=jnp.float32, maf=True)
    cm = make_mesh((n, n, n), devices=cpu8(), div=(2, 2, 2))
    serial_step = steps_mod.make_step(prob, name, 0.8)
    dist_step = make_dist_step(prob, cm, name, 0.8)
    x_s, x_d, b_d = prob.x0, cm.shard(prob.x0), cm.shard(prob.rhs)
    for _ in range(4):
        x_s, r_s = serial_step(x_s, prob.rhs)
        x_d, r_d = dist_step(x_d, b_d)
    np.testing.assert_allclose(np.asarray(x_d), np.asarray(x_s), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(float(r_d), float(r_s), rtol=1e-4)


def test_overlap_mode_bitwise_vs_sequential():
    # sync='overlap' computes the interior concurrently with the ghost
    # collectives; stencil deltas are pure elementwise ops, so the result
    # must be BITWISE identical to the sequential exchange-then-sweep step
    # (sor2sma covers the jacobi delta machinery per color)
    n = 16
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=cpu8(), div=(2, 2, 2))
    seq = jax.jit(make_dist_step(prob, cm, "sor2sma", 1.5))
    ovl = jax.jit(make_dist_step(prob, cm, "sor2sma", 1.5, sync="overlap"))
    x_s, x_o = cm.shard(prob.x0), cm.shard(prob.x0)
    b = cm.shard(prob.rhs)
    for _ in range(3):
        x_s, r_s = seq(x_s, b)
        x_o, r_o = ovl(x_o, b)
    np.testing.assert_array_equal(np.asarray(x_o), np.asarray(x_s))


def test_dist_maf_line_matches_serial_unsplit_k():
    # explicit sharded MAF line step (variable tridiagonals from the block's
    # metric-table slice): with K unsplit it must match the serial sweep
    n = 16
    prob = Problem.poisson_cube(n, dtype=jnp.float32, maf=True)
    cm = make_mesh((n, n, n), devices=cpu8(), div=(1, 2, 4))
    serial_step = steps_mod.make_step(prob, "pcr_rb_maf", 1.2)
    dist_step = make_dist_step(prob, cm, "pcr_rb_maf", 1.2)
    x_s, x_d, b_d = prob.x0, cm.shard(prob.x0), cm.shard(prob.rhs)
    for _ in range(3):
        x_s, r_s = serial_step(x_s, prob.rhs)
        x_d, r_d = dist_step(x_d, b_d)
    np.testing.assert_allclose(np.asarray(x_d), np.asarray(x_s), rtol=3e-5,
                               atol=1e-6)


def test_solve_dist_total_all_solvers():
    # every reference solver name must run under solve_dist (the reference
    # runs all of them multi-rank, cz_Poisson.cpp) — explicit shard_map
    # step or auto-SPMD fallback
    from cubez_tpu.parallel.api import solve_dist
    from cubez_tpu.solvers.steps import ALL_SOLVERS

    n = 16
    cm = make_mesh((n, n, n), devices=cpu8(), div=(2, 2, 2))
    for name in ALL_SOLVERS:
        if name.startswith("pbicgstab"):
            continue  # Krylov distributes via auto-SPMD in solve()
        maf = name.endswith("_maf")
        prob = Problem.poisson_cube(n, dtype=jnp.float32, maf=maf)
        r = solve_dist(prob, cm, name, omega=1.0, itr_max=3, eps=1e-30)
        assert r.iters == 3, name
        assert np.isfinite(r.res), name


def test_solve_dist_pbicgstab_fused_block_precond():
    # distributed BiCGSTAB: sharded Krylov vectors (psum dots) with the
    # preconditioner's jnp sweeps partitioned by GSPMD
    from cubez_tpu.parallel.api import solve_dist

    n = 16
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=cpu8(), div=(2, 2, 2))
    r_d = solve_dist(prob, cm, "pbicgstab", omega=1.1, itr_max=50,
                     precond="sor2sma")
    r_s = solve(prob, "pbicgstab", omega=1.1, itr_max=50,
                precond="sor2sma", impl="jnp")
    assert r_d.res < 1e-5
    assert abs(r_d.iters - r_s.iters) <= 1


# ---- the explicit jnp shard_map steps: the multi-device path ---------------

MESHES = [(2, 2, 2), (1, 2, 4), (4, 2, 1), (1, 1, 8)]


def _lowsync_rb_oracle(prob, cm, omega):
    """Reference multi-rank RB-SOR written out independently: ONE halo
    exchange per iteration (cz_Poisson.cpp:194-215), colors not re-synced
    in between."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from cubez_tpu.ops import stencil
    from cubez_tpu.parallel.dist import _global_color_masks
    from cubez_tpu.parallel.halo import exchange_halo, pad_zeros, psum_all
    from cubez_tpu.parallel.mesh import FIELD_SPEC

    dtype = prob.grid.dtype
    om = jnp.asarray(omega, dtype)

    def body(xb, bb, mb):
        xh = exchange_halo(xb)
        bh = pad_zeros(bb)
        cm0, cm1 = _global_color_masks(xb.shape, dtype)
        r2 = jnp.zeros((), dtype)
        for cmask in (cm0, cm1):
            dp = stencil.jacobi_delta(xh, bh, pad_zeros(mb * cmask), om)
            xh = xh + dp
            r2 = r2 + psum_all(jnp.sum(dp * dp))
        return xh[1:-1, 1:-1, 1:-1], r2

    fn = shard_map(body, mesh=cm.mesh,
                   in_specs=(FIELD_SPEC, FIELD_SPEC, FIELD_SPEC),
                   out_specs=(FIELD_SPEC, P()))
    return lambda x, b: fn(x, b, cm.shard(prob.msk))


@pytest.mark.parametrize("div", MESHES)
def test_sor2sma_color_step_matches_serial_on_mesh(div):
    """sync='color' (exchange before each color) is the serial sweep."""
    n = 16
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=cpu8(), div=div)
    serial = jax.jit(steps_mod.make_step(prob, "sor2sma", 1.5))
    dist = jax.jit(make_dist_step(prob, cm, "sor2sma", 1.5, sync="color"))
    x_s, x_d, b_d = prob.x0, cm.shard(prob.x0), cm.shard(prob.rhs)
    for _ in range(4):
        x_s, r_s = serial(x_s, prob.rhs)
        x_d, r_d = dist(x_d, b_d)
    assert float(jnp.max(jnp.abs(x_d - x_s))) < 1e-6
    np.testing.assert_allclose(float(r_d), float(r_s), rtol=1e-5)


@pytest.mark.parametrize("div", MESHES[:3])
def test_sor2sma_iter_step_matches_lowsync_oracle(div):
    n = 16
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=cpu8(), div=div)
    step = jax.jit(make_dist_step(prob, cm, "sor2sma", 1.5, sync="iter"))
    oracle = jax.jit(_lowsync_rb_oracle(prob, cm, 1.5))
    x1 = x2 = cm.shard(prob.x0)
    b = cm.shard(prob.rhs)
    for _ in range(4):
        x1, r1 = step(x1, b)
        x2, r2 = oracle(x2, b)
    assert float(jnp.max(jnp.abs(x1 - x2))) < 1e-6
    np.testing.assert_allclose(float(r1), float(r2), rtol=1e-5)


@pytest.mark.parametrize("maf", [False, True], ids=["const", "maf"])
def test_iter_equals_color_on_one_block(maf):
    """On a one-device mesh there are no ghosts to go stale: the
    one-exchange cadence is the per-color one (to FMA-contraction
    rounding: the two programs fuse differently)."""
    n = 16
    prob = Problem.poisson_cube(n, dtype=jnp.float32, maf=maf)
    cm = make_mesh((n, n, n), devices=cpu8()[:1], div=(1, 1, 1))
    name = "sor2sma_maf" if maf else "sor2sma"
    it = jax.jit(make_dist_step(prob, cm, name, 1.5, sync="iter"))
    co = jax.jit(make_dist_step(prob, cm, name, 1.5, sync="color"))
    x1 = x2 = cm.shard(prob.x0)
    b = cm.shard(prob.rhs)
    for _ in range(3):
        x1, r1 = it(x1, b)
        x2, r2 = co(x2, b)
    assert float(jnp.max(jnp.abs(x1 - x2))) < 1e-6
    np.testing.assert_allclose(float(r1), float(r2), rtol=1e-5)


@pytest.mark.parametrize("div", MESHES[:3])
def test_solve_dist_count_equals_serial(div):
    from cubez_tpu import max_error
    from cubez_tpu.parallel.api import solve_dist

    n = 16
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=cpu8(), div=div)
    r = solve_dist(prob, cm, "sor2sma", omega=1.5, itr_max=2000)
    rs = solve(prob, "sor2sma", omega=1.5, itr_max=2000, impl="jnp")
    assert r.res < 1e-5 and r.iters == rs.iters
    assert r.x.shape == prob.grid.shape_kij
    assert max_error(prob.grid, r.x) < 5e-3


def test_solve_dist_pcr_rb_converges():
    from cubez_tpu import max_error
    from cubez_tpu.parallel.api import solve_dist

    n = 16
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=cpu8(), div=(2, 2, 2))
    r = solve_dist(prob, cm, "pcr_rb", omega=1.5, itr_max=2000)
    assert r.res < 1e-5
    assert max_error(prob.grid, r.x) < 5e-3


def test_solve_dist_iter_cadence_converges():
    from cubez_tpu.parallel.api import solve_dist

    n = 16
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=cpu8(), div=(2, 2, 2))
    r = solve_dist(prob, cm, "sor2sma", omega=1.0, itr_max=4000, sync="iter")
    assert r.res < 1e-5


def test_solve_dist_rejects_unknown_sync():
    from cubez_tpu.parallel.api import solve_dist

    prob = Problem.poisson_cube(8)
    cm = make_mesh((8, 8, 8), devices=cpu8()[:2], div=(1, 1, 2))
    with pytest.raises(ValueError, match="sync"):
        solve_dist(prob, cm, "sor2sma", omega=1.5, itr_max=5, sync="pack")


def test_solve_dist_rejects_sync_without_a_step():
    from cubez_tpu.parallel.api import solve_dist

    prob = Problem.poisson_cube(8)
    cm = make_mesh((8, 8, 8), devices=cpu8()[:2], div=(1, 1, 2))
    with pytest.raises(NotImplementedError, match="sync='iter'"):
        solve_dist(prob, cm, "pcr_rb", omega=1.5, itr_max=5, sync="iter")
