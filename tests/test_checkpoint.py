"""Checkpoint/restart round-trip: split solve == straight solve."""

import jax.numpy as jnp
import numpy as np

from cubez_tpu import Problem, solve
from cubez_tpu.utils import checkpoint


def test_checkpoint_resume_matches_straight_solve(tmp_path):
    prob = Problem.poisson_cube(24, dtype=jnp.float32)

    straight = solve(prob, "sor2sma", omega=1.5, itr_max=400, impl="jnp")
    assert straight.res < 1e-5

    # run 50 iterations, checkpoint, resume
    part1 = solve(prob, "sor2sma", omega=1.5, itr_max=50, impl="jnp")
    p = tmp_path / "ck.npz"
    checkpoint.save(
        p, part1.x, solver="sor2sma", iters=part1.iters, res=part1.res,
        omega=1.5, eps=1e-5, history=part1.history,
    )
    ck = checkpoint.load(p)
    assert ck.iters == 50 and ck.solver == "sor2sma"

    part2 = checkpoint.resume(prob, ck, itr_max=400, impl="jnp")
    assert part2.res < 1e-5
    # same total work and same final state as the straight solve
    assert part1.iters + part2.iters == straight.iters
    np.testing.assert_allclose(
        np.asarray(part2.x), np.asarray(straight.x), atol=1e-6
    )


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    prob = Problem.poisson_cube(24, dtype=jnp.float32)
    p = tmp_path / "ck.npz"
    checkpoint.save(p, prob.x0, solver="jacobi", iters=0, res=1.0, omega=0.8, eps=1e-5)
    ck = checkpoint.load(p)
    other = Problem.poisson_cube(16, dtype=jnp.float32)
    try:
        checkpoint.resume(other, ck, itr_max=10)
        assert False, "expected ValueError"
    except ValueError:
        pass


def test_sharded_checkpoint_resume_matches_straight(tmp_path):
    """save -> load -> resume on the 8-device mesh equals the
    uninterrupted sharded solve (the per-color cadence is serial-exact,
    so the split is bitwise)."""
    import jax

    from cubez_tpu.parallel.api import solve_dist
    from cubez_tpu.parallel.mesh import make_mesh

    n = 32
    prob = Problem.poisson_cube(n, dtype=jnp.float32)
    cm = make_mesh((n, n, n), devices=jax.devices("cpu")[:8], div=(2, 2, 2))

    straight = solve_dist(prob, cm, "sor2sma", omega=1.5, itr_max=2000,
                          eps=1e-5, sync="color")
    assert straight.iters == 199  # == the serial oracle

    # split at a multiple of the check cadence so the returned field has
    # run exactly the reported number of sweeps
    part1 = solve_dist(prob, cm, "sor2sma", omega=1.5, itr_max=48,
                       eps=1e-5, sync="color")
    assert part1.iters == 48
    p = tmp_path / "ck_sharded.npz"
    checkpoint.save(
        p, part1.x, solver="sor2sma", iters=part1.iters, res=part1.res,
        omega=1.5, eps=1e-5, history=part1.history,
    )
    part2 = checkpoint.resume_dist(
        prob, cm, checkpoint.load(p), itr_max=2000, sync="color",
    )
    assert part1.iters + part2.iters == straight.iters
    np.testing.assert_array_equal(
        np.asarray(part2.x), np.asarray(straight.x)
    )
