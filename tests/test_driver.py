"""Convergence-driver semantics: chunked checking must not change reported
iteration counts or histories (cz_Poisson.cpp:39-79 checks every iteration;
we check every N but recover the exact stopping iteration)."""

import jax.numpy as jnp
import numpy as np

from cubez_tpu import Problem, solve
from cubez_tpu.solvers.driver import run_iterative
from cubez_tpu.solvers.fused_cache import get_jnp_step


def test_chunked_matches_per_iteration():
    prob = Problem.poisson_cube(24)
    step = get_jnp_step(prob, "sor2sma", 1.5)
    g = prob.grid
    r1 = run_iterative(step, prob.x0, prob.rhs, g.res_normal, 2000,
                       eps=1e-5, check_every=1)
    r16 = run_iterative(step, prob.x0, prob.rhs, g.res_normal, 2000,
                        eps=1e-5, check_every=16)
    assert r1.iters == r16.iters
    # scan- vs while-compiled sweeps may differ in reduction schedule ->
    # f32-ulp history differences; semantics (count + curve) are identical
    np.testing.assert_allclose(r1.history, r16.history, rtol=1e-6)
    # chunking may run past the stopping iteration inside the final chunk;
    # those extra sweeps strictly continue the relaxation
    assert float(r16.res) <= float(r1.res) * (1 + 1e-6)


def test_chunked_hits_itr_max_exactly():
    prob = Problem.poisson_cube(16)
    step = get_jnp_step(prob, "jacobi", 0.8)
    g = prob.grid
    # itr_max not a multiple of the chunk; eps unreachable
    r = run_iterative(step, prob.x0, prob.rhs, g.res_normal, 37,
                      eps=1e-30, check_every=16)
    assert r.iters == 37
    assert len(r.history) == 37


def test_chunked_final_chunk_overshoot_respects_itr_max():
    """A solve that first converges INSIDE the final chunk's overshoot
    region (past itr_max but before the chunk boundary) must report
    iters == itr_max, unconverged — exactly like per-iteration checking."""
    prob = Problem.poisson_cube(24)
    step = get_jnp_step(prob, "sor2sma", 1.5)
    g = prob.grid
    full = run_iterative(step, prob.x0, prob.rhs, g.res_normal, 2000,
                         eps=1e-5, check_every=1)
    c = full.iters  # true convergence iteration
    itr_max = c - 3
    chunk = 16
    # the scenario requires the rounded-up chunk total to cover c
    assert -(-itr_max // chunk) * chunk >= c
    r1 = run_iterative(step, prob.x0, prob.rhs, g.res_normal, itr_max,
                       eps=1e-5, check_every=1)
    rc = run_iterative(step, prob.x0, prob.rhs, g.res_normal, itr_max,
                       eps=1e-5, check_every=chunk)
    assert r1.iters == itr_max and float(r1.res) >= 1e-5
    assert rc.iters == itr_max
    assert float(rc.res) >= 1e-5 * (1 - 1e-6)
    assert len(rc.history) == itr_max


def test_chunk_clamped_to_itr_max():
    """A rate run (tiny itr_max, unreachable eps) must execute exactly
    itr_max sweeps even when check_every exceeds it — the returned field
    equals the per-iteration run's, not 'itr_max counted out of a full
    chunk of surplus sweeps' (which silently under-reported the psor/pcr
    per-iteration rates by ~5x under a default chunk of 16)."""
    prob = Problem.poisson_cube(16)
    step = get_jnp_step(prob, "jacobi", 0.8)
    g = prob.grid
    r1 = run_iterative(step, prob.x0, prob.rhs, g.res_normal, 3,
                       eps=1e-30, check_every=1)
    r16 = run_iterative(step, prob.x0, prob.rhs, g.res_normal, 3,
                        eps=1e-30, check_every=16)
    assert r1.iters == r16.iters == 3
    assert (np.asarray(r1.x) == np.asarray(r16.x)).all()


def test_eps_1e6_f32_iteration_parity_with_f64():
    """BASELINE's stricter 1e-6 tolerance: the f32 path must reach it with
    the same iteration count as the f64 oracle (residual accumulation is
    effectively double; cz_solver.f90:214-215)."""
    p32 = Problem.poisson_cube(32, dtype=jnp.float32)
    p64 = Problem.poisson_cube(32, dtype=jnp.float64)
    r32 = solve(p32, "sor2sma", omega=1.5, itr_max=5000, eps=1e-6, impl="jnp")
    r64 = solve(p64, "sor2sma", omega=1.5, itr_max=5000, eps=1e-6, impl="jnp")
    assert r32.res < 1e-6 and r64.res < 1e-6
    assert abs(r32.iters - r64.iters) <= max(1, r64.iters // 100)
