"""Parity against reference-semantics histories (tests/ref_histories/).

The reference's verification currency is residual histories per solver
(cz_Evaluate.cpp:210-218, doc/Memo.md:134 compares variants purely by
history).  These tests compare the framework's histories against serial
reference-semantics runs produced by tools/ref_oracle.cpp (see
tests/ref_histories/README.md for why the oracle stands in for the
unbuildable Fortran reference binary).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from cubez_tpu import Problem, solve

HIST = pathlib.Path(__file__).parent / "ref_histories"


def load(name):
    rows = (HIST / name).read_text().splitlines()[1:]
    return np.array([float(ln.split(",")[1]) for ln in rows])


CASES = [
    # solver, omega, history file (32^3 fast tier)
    ("jacobi", 0.8, "jacobi_32_w0.8.txt"),
    ("psor", 1.1, "psor_32_w1.1.txt"),
    ("sor2sma", 1.5, "sor2sma_32_w1.5.txt"),
    ("pcr", 1.5, "pcr_32_w1.5.txt"),
    ("pcr_rb", 1.5, "pcr_rb_32_w1.5.txt"),
    ("pcr_j_esa", 1.0, "pcr_j_esa_32_w1.0.txt"),
]


@pytest.mark.parametrize("name,omega,fname", CASES)
def test_f64_history_parity(name, omega, fname):
    """f64 framework histories must track the f64 serial reference run:
    identical iteration counts (+-1%) and residual curves to fp tolerance."""
    ref = load("f64_" + fname)
    prob = Problem.poisson_cube(32, dtype=jnp.float64)
    r = solve(prob, name, omega=omega, itr_max=40000, eps=1e-5, impl="jnp")
    assert abs(r.iters - len(ref)) <= max(1, len(ref) // 100), (
        f"{name}: {r.iters} vs reference {len(ref)} iterations"
    )
    m = min(r.iters, len(ref))
    np.testing.assert_allclose(r.history[:m], ref[:m], rtol=1e-6)


@pytest.mark.parametrize(
    "name,omega,fname",
    [c for c in CASES if c[0] in ("jacobi", "sor2sma", "pcr_rb")],
)
def test_f32_iteration_parity(name, omega, fname):
    """f32 (the reference's default REAL_TYPE) iteration counts match the
    f32 serial reference run; curves agree to f32 roundoff over the bulk."""
    ref = load("f32_" + fname)
    prob = Problem.poisson_cube(32, dtype=jnp.float32)
    r = solve(prob, name, omega=omega, itr_max=40000, eps=1e-5, impl="jnp")
    assert abs(r.iters - len(ref)) <= max(1, len(ref) // 50)
    m = min(r.iters, len(ref)) - 1  # last entry straddles the threshold
    np.testing.assert_allclose(r.history[:m], ref[:m], rtol=1e-3)


def test_pbicgstab_history_parity_f64():
    ref = load("f64_pbicgstab_sor2sma_32_w1.1.txt")
    prob = Problem.poisson_cube(32, dtype=jnp.float64)
    r = solve(prob, "pbicgstab", omega=1.1, itr_max=4000, eps=1e-5,
              precond="sor2sma", impl="jnp")
    assert abs(r.iters - len(ref)) <= 1
    m = min(r.iters, len(ref)) - 1
    np.testing.assert_allclose(r.history[:m], ref[:m], rtol=1e-4)


def test_reference_128_iteration_counts_checked_in():
    """Checked-in 128^3 reference histories: iteration counts the framework
    must reproduce on the card (compared live by chip_smoke.py)."""
    expect = {
        "f32_sor2sma_128_w1.5.txt": 1813,
        "f64_sor2sma_128_w1.5.txt": 1813,
        "f32_jacobi_128_w0.8.txt": 5378,
        "f32_psor_128_w1.1.txt": 3249,
        "f32_pcr_128_w1.5.txt": 1357,
        "f32_pcr_rb_128_w1.5.txt": 1356,
        "f32_pbicgstab_sor2sma_128_w1.1.txt": 20,
        # BASELINE's stricter 1e-6 tolerance at 128^3: f32 tracks f64 to
        # one iteration (double residual accumulation, cz_solver.f90:214-215)
        "f32_sor2sma_128_w1.5_eps1e-6.txt": 3066,
        "f64_sor2sma_128_w1.5_eps1e-6.txt": 3065,
        # BASELINE config 4: pbicgstab 256^3 f64 oracle evidence
        "f64_pbicgstab_sor2sma_256_w1.1.txt": 38,
    }
    for fname, iters in expect.items():
        assert len(load(fname)) == iters, fname


# --- MAF (variable-coefficient) family --------------------------------------
#
# The oracle implements the MAF kernels literally (psor_maf cz_maf.f90:23-114,
# jacobi_maf :131-282, psor2sma_core_maf :301-438, pcr_rb_maf :442-668,
# pcr_maf :672-892, calc_rk/ax_maf + search_pivot cz_blas.f90:738-1039) on the
# driver's uniform coordinates (cz_Evaluate.cpp:88,342-363).  On the uniform
# cube the MAF operator is numerically ~= the constant-coefficient one, but
# the metric arithmetic perturbs every coefficient by ulps, so these histories
# are genuinely distinct files — the framework's MAF pipeline must track them
# by the same standard as the constant-coefficient family.

MAF_CASES = [
    ("psor_maf", 1.1, "psor_maf_32_w1.1.txt"),
    ("jacobi_maf", 0.8, "jacobi_maf_32_w0.8.txt"),
    ("sor2sma_maf", 1.5, "sor2sma_maf_32_w1.5.txt"),
    ("pcr_maf", 1.5, "pcr_maf_32_w1.5.txt"),
    ("pcr_rb_maf", 1.5, "pcr_rb_maf_32_w1.5.txt"),
]


@pytest.mark.parametrize("name,omega,fname", MAF_CASES)
def test_maf_f64_history_parity(name, omega, fname):
    """f64 MAF histories track the f64 serial MAF oracle: identical iteration
    counts (+-1%) and residual curves to the history-file quantization."""
    ref = load("f64_" + fname)
    prob = Problem.poisson_cube(32, dtype=jnp.float64, maf=True)
    r = solve(prob, name, omega=omega, itr_max=40000, eps=1e-5, impl="jnp")
    assert abs(r.iters - len(ref)) <= max(1, len(ref) // 100), (
        f"{name}: {r.iters} vs reference {len(ref)} iterations"
    )
    m = min(r.iters, len(ref))
    np.testing.assert_allclose(r.history[:m], ref[:m], rtol=1e-6)


@pytest.mark.parametrize(
    "name,omega,fname",
    [c for c in MAF_CASES if c[0] in ("sor2sma_maf", "pcr_rb_maf")],
)
def test_maf_f32_iteration_parity(name, omega, fname):
    """f32 MAF iteration counts match the f32 serial MAF oracle."""
    ref = load("f32_" + fname)
    prob = Problem.poisson_cube(32, dtype=jnp.float32, maf=True)
    r = solve(prob, name, omega=omega, itr_max=40000, eps=1e-5, impl="jnp")
    assert abs(r.iters - len(ref)) <= max(1, len(ref) // 50)
    m = min(r.iters, len(ref)) - 1
    np.testing.assert_allclose(r.history[:m], ref[:m], rtol=1e-3)


def test_pbicgstab_maf_history_parity_f64():
    """MAF-BiCGSTAB (pvt row scaling + MAF preconditioner sweeps) tracks the
    oracle's pbicgstab_maf/sor2sma_maf run."""
    ref = load("f64_pbicgstab_maf_sor2sma_maf_32_w1.1.txt")
    prob = Problem.poisson_cube(32, dtype=jnp.float64, maf=True)
    r = solve(prob, "pbicgstab_maf", omega=1.1, itr_max=4000, eps=1e-5,
              precond="sor2sma_maf", impl="jnp")
    assert abs(r.iters - len(ref)) <= 1
    m = min(r.iters, len(ref)) - 1
    np.testing.assert_allclose(r.history[:m], ref[:m], rtol=1e-4)


def test_maf_reference_128_iteration_counts_checked_in():
    """Checked-in 128^3 MAF oracle histories (chip_smoke.py compares the
    sor2sma_maf count live on the card)."""
    # Counts pinned at generation time.
    # Within +-1 of the constant-coefficient counts everywhere (the f32
    # metric arithmetic perturbs each coefficient by ulps): sor2sma 1813,
    # psor 3249, jacobi 5377 (const 5378), pcr 1356 (const 1357),
    # pcr_rb 1355 (const 1356), pbicgstab 19 (const 20).
    pinned = {
        "f32_sor2sma_maf_128_w1.5.txt": 1813,
        "f32_psor_maf_128_w1.1.txt": 3249,
        "f32_jacobi_maf_128_w0.8.txt": 5377,
        "f32_pcr_maf_128_w1.5.txt": 1356,
        "f32_pcr_rb_maf_128_w1.5.txt": 1355,
        "f32_pbicgstab_maf_sor2sma_maf_128_w1.1.txt": 19,
    }
    for fname, iters in pinned.items():
        assert len(load(fname)) == iters, fname
