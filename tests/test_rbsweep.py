"""The red-black Triton kernel (pallas_kernels/rbsweep.py) in the Pallas
interpreter on the CPU, against the plain jnp step.

On the card the same kernel is compiled and compared at 128^3 and 512^3 by
``python chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cubez_tpu import Problem, solve
from cubez_tpu.pallas_kernels import rbsweep
from cubez_tpu.solvers.steps import make_step

# (nk, ni, nj): even, odd I, odd K and J, non-cubic
SHAPES = [(16, 16, 16), (12, 17, 10), (9, 14, 11)]


def _problem(shape, maf, zero_b, seed=0):
    nk, ni, nj = shape
    prob = Problem.poisson_cube((ni, nj, nk), dtype=jnp.float32, maf=maf)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    x0 = prob.x0 + 0.1 * jax.random.normal(k1, shape, jnp.float32) * prob.msk
    b = (
        jnp.zeros(shape, jnp.float32) if zero_b
        else 0.1 * jax.random.normal(k2, shape, jnp.float32) * prob.msk
    )
    return dataclasses.replace(prob, x0=x0, rhs=b, rhs_inner_zero=zero_b)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_pack_roundtrip(shape, offset):
    a = jax.random.normal(jax.random.PRNGKey(3), shape, jnp.float32)
    p = rbsweep.pack_rb(a, offset)
    assert p.shape == (2, shape[0], (shape[1] + 1) // 2, shape[2])
    np.testing.assert_array_equal(
        np.asarray(rbsweep.unpack_rb(p, shape, offset)), np.asarray(a)
    )


@pytest.mark.parametrize("offset", [0, 1])
def test_pack_colors_follow_checkerboard(offset):
    """Packed slot c holds exactly the nodes of color c
    ((i + j + k + offset + 1) % 2 == c, stencil.color_masks)."""
    from cubez_tpu.ops import stencil

    shape = (6, 9, 7)
    c0, c1 = stencil.color_masks(shape, offset=offset)
    p0 = rbsweep.pack_rb(c0, offset)
    p1 = rbsweep.pack_rb(c1, offset)
    # color 0's slot holds ones of c0 (padding row of odd I holds zeros)
    real = rbsweep.pack_rb(jnp.ones(shape), offset)
    np.testing.assert_array_equal(np.asarray(p0[0]), np.asarray(real[0]))
    np.testing.assert_array_equal(np.asarray(p1[1]), np.asarray(real[1]))
    assert float(jnp.sum(p0[1])) == 0.0 and float(jnp.sum(p1[0])) == 0.0


@pytest.mark.parametrize("maf", [False, True], ids=["const", "maf"])
@pytest.mark.parametrize("zero_b", [True, False], ids=["b0", "b"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_sweep_matches_jnp_step(shape, offset, zero_b, maf):
    """Three red-black iterations through the kernel equal the jnp step's
    (same color offset, same RHS) to f32 rounding, residual included."""
    prob = _problem(shape, maf, zero_b)
    name = "sor2sma_maf" if maf else "sor2sma"
    ref = make_step(prob, name, 1.5, color_offset=offset)
    step = rbsweep.make_rb_step(
        shape, jnp.float32, omega=1.5, offset=offset,
        mc=prob.mc if maf else None, b_is_zero=zero_b, interpret=True,
    )
    p, bp = step.pad(prob.x0), step.pad(prob.rhs)
    x = prob.x0
    for _ in range(3):
        p, r2k = jax.jit(step)(p, bp)
        x, r2j = ref(x, prob.rhs)
        xk = step.unpad(p)
        assert float(jnp.max(jnp.abs(xk - x))) < 1e-6
        np.testing.assert_allclose(float(r2k), float(r2j), rtol=1e-5)


def test_b_is_zero_ignores_rhs_and_keeps_boundary():
    """The zero-RHS form never reads b (garbage b changes nothing), and
    no boundary node ever changes."""
    shape = (12, 17, 10)
    prob = _problem(shape, False, True)
    step = rbsweep.make_rb_step(shape, omega=1.5, b_is_zero=True,
                                interpret=True)
    p = step.pad(prob.x0)
    garbage = step.pad(jnp.full(shape, 1e6, jnp.float32))
    p1, r1 = step(p, p)
    p2, r2 = step(p, garbage)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    assert float(r1) == float(r2)
    x = step.unpad(p1)
    shell = 1.0 - prob.msk
    np.testing.assert_array_equal(
        np.asarray(x * shell), np.asarray(prob.x0 * shell)
    )


@pytest.mark.parametrize(
    "shape", [(3, 40, 130), (4, 33, 129), (3, 64, 256)],
    ids=["partial-i-and-j", "odd-i-partial-j", "whole-tiles"],
)
def test_multi_tile_grid_matches_jnp_step(shape):
    """Grids of several full-size tiles (16 rows of i2 by 128 of j), with
    partial last tiles or without: every program masks its own edges and
    reads its neighbours across tile borders."""
    prob = _problem(shape, False, False)
    ref = make_step(prob, "sor2sma", 1.5)
    step = rbsweep.make_rb_step(shape, omega=1.5, interpret=True)
    assert (shape[1] + 1) // 2 > rbsweep.BLOCK[0]
    assert shape[2] >= rbsweep.BLOCK[1]
    p, bp = step.pad(prob.x0), step.pad(prob.rhs)
    p, r2k = jax.jit(step)(p, bp)
    x, r2j = ref(prob.x0, prob.rhs)
    assert float(jnp.max(jnp.abs(step.unpad(p) - x))) < 1e-6
    np.testing.assert_allclose(float(r2k), float(r2j), rtol=1e-5)


@pytest.mark.parametrize("name", ["sor2sma", "sor2sma_maf"])
def test_solve_through_kernel_matches_jnp_counts(name, interpret_kernel):
    """solve() picks the kernel (dispatcher on a GPU backend) and reaches
    the jnp step's iteration count, which is the oracle's (199 at 32^3)."""
    prob = Problem.poisson_cube(32, dtype=jnp.float32,
                                maf=name.endswith("_maf"))
    rk = solve(prob, name, omega=1.5, itr_max=2000)
    rj = solve(prob, name, omega=1.5, itr_max=2000, impl="jnp")
    assert rk.iters == rj.iters == 199
    np.testing.assert_allclose(np.asarray(rk.history), np.asarray(rj.history),
                               rtol=1e-4)
    assert float(jnp.max(jnp.abs(rk.x - rj.x))) < 1e-5


@pytest.mark.gpu
def test_compiled_kernel_matches_jnp_on_gpu(gpu_device):
    """The kernel compiled for the card (no interpreter) against the jnp
    step at 64^3."""
    with jax.default_device(gpu_device):
        prob = Problem.poisson_cube(64, dtype=jnp.float32)
        ref = jax.jit(make_step(prob, "sor2sma", 1.5))
        step = rbsweep.make_rb_step(prob.grid.shape_kij, omega=1.5,
                                    b_is_zero=True)
        p = step.pad(prob.x0)
        x = prob.x0
        for _ in range(5):
            p, r2k = jax.jit(step)(p, p)
            x, r2j = ref(x, prob.rhs)
        assert float(jnp.max(jnp.abs(step.unpad(p) - x))) <= 1e-6
        np.testing.assert_allclose(float(r2k), float(r2j), rtol=1e-5)
