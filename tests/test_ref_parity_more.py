"""More parity cases against the checked-in oracle histories
(tests/ref_histories/, tools/ref_oracle.cpp): the f32 forms at 32^3 that
test_ref_parity.py leaves out, and 64^3 for the solvers whose jnp steps are
the production path on every backend (see solvers/dispatch.py)."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from cubez_tpu import Problem, solve

HIST = pathlib.Path(__file__).parent / "ref_histories"


def load(name):
    rows = (HIST / name).read_text().splitlines()[1:]
    return np.array([float(ln.split(",")[1]) for ln in rows])


def _run(name, n, dtype, omega, precond=None):
    prob = Problem.poisson_cube(n, dtype=dtype, maf="_maf" in name)
    return solve(prob, name, omega=omega, itr_max=40000, eps=1e-5,
                 precond=precond, impl="jnp")


F32_32 = [
    ("psor", 1.1, "f32_psor_32_w1.1.txt"),
    ("pcr", 1.5, "f32_pcr_32_w1.5.txt"),
    ("pcr_j_esa", 1.0, "f32_pcr_j_esa_32_w1.0.txt"),
    ("jacobi_maf", 0.8, "f32_jacobi_maf_32_w0.8.txt"),
    ("psor_maf", 1.1, "f32_psor_maf_32_w1.1.txt"),
    ("pcr_maf", 1.5, "f32_pcr_maf_32_w1.5.txt"),
]


@pytest.mark.parametrize("name,omega,fname", F32_32)
def test_f32_32_iteration_parity(name, omega, fname):
    """f32 counts within 2% of the f32 oracle; curves to f32 roundoff."""
    ref = load(fname)
    r = _run(name, 32, jnp.float32, omega)
    assert abs(r.iters - len(ref)) <= max(1, len(ref) // 50)
    m = min(r.iters, len(ref)) - 1
    np.testing.assert_allclose(r.history[:m], ref[:m], rtol=1e-3)


@pytest.mark.parametrize(
    "name,precond,fname",
    [
        ("pbicgstab", "sor2sma", "f32_pbicgstab_sor2sma_32_w1.1.txt"),
        ("pbicgstab_maf", "sor2sma_maf",
         "f32_pbicgstab_maf_sor2sma_maf_32_w1.1.txt"),
    ],
)
def test_f32_32_pbicgstab_parity(name, precond, fname):
    ref = load(fname)
    r = _run(name, 32, jnp.float32, 1.1, precond)
    assert abs(r.iters - len(ref)) <= 1
    m = min(r.iters, len(ref)) - 1
    np.testing.assert_allclose(r.history[:m], ref[:m], rtol=1e-3)


F64_64 = [
    ("sor2sma", 1.5, "f64_sor2sma_64_w1.5.txt"),
    ("sor2sma_maf", 1.5, "f64_sor2sma_maf_64_w1.5.txt"),
    ("pcr_rb", 1.5, "f64_pcr_rb_64_w1.5.txt"),
    ("pcr_rb_maf", 1.5, "f64_pcr_rb_maf_64_w1.5.txt"),
    ("jacobi", 0.8, "f64_jacobi_64_w0.8.txt"),
]


@pytest.mark.parametrize("name,omega,fname", F64_64)
def test_f64_64_history_parity(name, omega, fname):
    """f64 histories at 64^3 track the f64 oracle: counts within 1%,
    residual curves to the history file's 7 digits."""
    ref = load(fname)
    r = _run(name, 64, jnp.float64, omega)
    assert abs(r.iters - len(ref)) <= max(1, len(ref) // 100)
    m = min(r.iters, len(ref))
    np.testing.assert_allclose(r.history[:m], ref[:m], rtol=1e-6)


@pytest.mark.parametrize(
    "name,omega,fname",
    [
        ("sor2sma", 1.5, "f32_sor2sma_64_w1.5.txt"),
        ("sor2sma_maf", 1.5, "f32_sor2sma_maf_64_w1.5.txt"),
        ("pcr_rb", 1.5, "f32_pcr_rb_64_w1.5.txt"),
    ],
)
def test_f32_64_iteration_parity(name, omega, fname):
    ref = load(fname)
    r = _run(name, 64, jnp.float32, omega)
    assert abs(r.iters - len(ref)) <= max(1, len(ref) // 50)
    m = min(r.iters, len(ref)) - 1
    np.testing.assert_allclose(r.history[:m], ref[:m], rtol=1e-3)


@pytest.mark.parametrize(
    "name,precond,fname",
    [
        ("pbicgstab", "sor2sma", "f64_pbicgstab_sor2sma_64_w1.1.txt"),
        ("pbicgstab_maf", "sor2sma_maf",
         "f64_pbicgstab_maf_sor2sma_maf_64_w1.1.txt"),
    ],
)
def test_f64_64_pbicgstab_parity(name, precond, fname):
    ref = load(fname)
    r = _run(name, 64, jnp.float64, 1.1, precond)
    assert abs(r.iters - len(ref)) <= 1
    m = min(r.iters, len(ref)) - 1
    np.testing.assert_allclose(r.history[:m], ref[:m], rtol=1e-4)
