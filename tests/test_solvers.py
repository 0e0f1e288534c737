"""End-to-end solver tests: analytic-solution max-error checks (the
reference's debug-mode verification, cz_Evaluate.cpp:550-563) and
cross-solver consistency."""

import jax.numpy as jnp
import numpy as np
import pytest

from cubez_tpu import Problem, max_error, solve

N = 32  # small cube keeps CPU tests fast; discretization error ~ O(h^2)


def _solve(name, omega, n=N, dtype=jnp.float32, itr_max=20000, **kw):
    maf = name.endswith("_maf") or kw.pop("maf", False)
    prob = Problem.poisson_cube(n, dtype=dtype, maf=maf)
    return prob, solve(prob, name, omega=omega, itr_max=itr_max, **kw)


# Pure discretization error at N=32 is ~6e-4 (measured with a 1e-11 deep
# solve); at the reference's eps=1e-5 stopping rule the remaining *algebraic*
# error dominates (the reference behaves the same — the stopping test is on
# RMS(dp), not the true residual).  Bound for eps=1e-5 runs:
DISC_ERR = 1e-2


@pytest.mark.parametrize(
    "name,omega",
    [
        ("jacobi", 0.8),
        ("sor2sma", 1.5),
        # 'pcr' is the serial reference's line-Gauss-Seidel (wavefront-exact
        # here), stable at the documented omega=1.5 (Readme.md:390);
        # 'pcr_j_esa' is the Jacobi-update form, which requires omega <~ 1.0
        # (the serial oracle diverges at 1.1 — tools/ref_oracle.cpp).
        ("pcr", 1.5),
        ("pcr_j_esa", 1.0),
        ("pcr_rb", 1.5),
    ],
)
def test_converges_to_analytic(name, omega):
    prob, res = _solve(name, omega)
    assert res.res < 1.0e-5, f"{name} did not converge: {res.res}"
    assert res.iters < 20000
    err = max_error(prob.grid, res.x)
    assert err < DISC_ERR, f"{name}: analytic max error {err}"


def test_psor_converges():
    prob, res = _solve("psor", 1.1, n=16, itr_max=4000)
    assert res.res < 1.0e-5
    err = max_error(prob.grid, res.x)
    assert err < 2e-2  # h ~ 1/15 discretization error


def test_psor_diag_scan_matches_hyperplane_exact():
    """The production psor step (diagonal-plane affine scans,
    ops/psor_scan.py) follows the SAME serial Gauss-Seidel dependency order
    as the bitwise-exact hyperplane sweep (ops/stencil.py::psor_sweep) — in
    f64 the two must agree to machine epsilon, const AND MAF."""
    import jax

    from cubez_tpu.ops import psor_scan, stencil
    from cubez_tpu.ops import maf as maf_ops

    prob = Problem.poisson_cube(20, dtype=jnp.float64)
    hidx = stencil.hyperplane_index(prob.grid.shape_kij)
    fast = psor_scan.make_psor_diag_step(prob.grid.shape_kij, jnp.float64, 1.1)
    xa = prob.x0
    xb, bs = fast._pre(prob.x0), fast._pre(prob.rhs)
    for _ in range(3):
        xa, r2a = stencil.psor_sweep(xa, prob.rhs, prob.msk, 1.1, hidx)
        xb, r2b = fast(xb, bs)
    np.testing.assert_allclose(np.asarray(xa), np.asarray(fast._post(xb)),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(float(r2a), float(r2b), rtol=1e-13)
    # skew/unskew round-trip is exact
    np.testing.assert_array_equal(
        np.asarray(fast._post(fast._pre(prob.x0))), np.asarray(prob.x0)
    )

    # MAF: hyperplane loop with metric coefficients vs the scan step
    prob, _ = Problem.manufactured_stretched(20, dtype=jnp.float64)
    fastm = psor_scan.make_psor_diag_step(
        prob.grid.shape_kij, jnp.float64, 1.1, mc=prob.mc
    )
    smax = 3 * (20 - 2)

    def hyper_maf(x, b):
        def body(s, carry):
            xx, r2 = carry
            m = prob.msk * (hidx == s).astype(x.dtype)
            dp = maf_ops.maf_delta(xx, b, m, 1.1, prob.mc)
            return xx + dp, r2 + jnp.sum(dp * dp)

        return jax.lax.fori_loop(3, smax + 1, body,
                                 (x, jnp.zeros((), x.dtype)))

    xa = prob.x0
    xb, bs = fastm._pre(prob.x0), fastm._pre(prob.rhs)
    for _ in range(3):
        xa, r2a = hyper_maf(xa, prob.rhs)
        xb, r2b = fastm(xb, bs)
    np.testing.assert_allclose(np.asarray(xa), np.asarray(fastm._post(xb)),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(float(r2a), float(r2b), rtol=1e-13)


def test_history_monotone_tail():
    _, res = _solve("sor2sma", 1.5)
    h = res.history
    assert len(h) == res.iters
    assert h[-1] < 1.0e-5
    assert h[-1] <= h[0]


def test_jacobi_maf_matches_jacobi_on_uniform_grid():
    # On the uniform grid the MAF metrics reduce to the constant-coefficient
    # operator scaled by 1/h^2, so iteration histories must agree closely.
    _, r_const = _solve("jacobi", 0.8, n=24, itr_max=6000)
    _, r_maf = _solve("jacobi_maf", 0.8, n=24, itr_max=6000)
    assert abs(r_const.iters - r_maf.iters) <= max(2, 0.01 * r_const.iters)
    m = min(r_const.iters, r_maf.iters)
    np.testing.assert_allclose(
        r_const.history[: m // 2], r_maf.history[: m // 2], rtol=1e-3
    )


@pytest.mark.parametrize("name,omega", [("sor2sma_maf", 1.5), ("pcr_maf", 1.5),
                                        ("pcr_rb_maf", 1.5)])
def test_maf_variants_converge(name, omega):
    prob, res = _solve(name, omega, n=24, itr_max=20000)
    assert res.res < 1.0e-5
    err = max_error(prob.grid, res.x)
    assert err < 8e-3


def test_pcr_aliases_identical():
    # eda/esa are memory-layout variants of the same serial line-GS math
    # (identical histories per doc/Memo.md:134): bitwise-identical here
    _, r1 = _solve("pcr", 1.5, n=24, itr_max=2000)
    _, r2 = _solve("pcr_esa", 1.5, n=24, itr_max=2000)
    assert r1.iters == r2.iters
    np.testing.assert_array_equal(r1.history, r2.history)
    # pcr_rb_esa aliases pcr_rb the same way
    _, r3 = _solve("pcr_rb", 1.5, n=24, itr_max=2000)
    _, r4 = _solve("pcr_rb_esa", 1.5, n=24, itr_max=2000)
    assert r3.iters == r4.iters
    np.testing.assert_array_equal(r3.history, r4.history)


def test_float64():
    # deep f64 convergence reaches the pure discretization error (~6e-4 at N=32)
    prob, res = _solve("sor2sma", 1.5, dtype=jnp.float64, eps=1e-10, itr_max=50000)
    assert res.res < 1e-10
    err = max_error(prob.grid, res.x)
    assert err < 1e-3


def test_pbicgstab_sor2sma_precond():
    prob, res = _solve(
        "pbicgstab", 1.1, precond="sor2sma", itr_max=4000
    )
    assert res.res < 1.0e-5
    assert res.iters < 100  # Krylov + preconditioner converges fast
    err = max_error(prob.grid, res.x)
    assert err < DISC_ERR


def test_pbicgstab_no_precond():
    prob, res = _solve("pbicgstab", 1.1, itr_max=4000)
    assert res.res < 1.0e-5
    err = max_error(prob.grid, res.x)
    assert err < DISC_ERR


def test_pbicgstab_maf():
    prob, res = _solve("pbicgstab_maf", 1.1, precond="sor2sma_maf", itr_max=4000)
    assert res.res < 1.0e-5
    err = max_error(prob.grid, res.x)
    assert err < DISC_ERR


def test_history_file_format(tmp_path):
    _, res = _solve("jacobi", 0.8, n=16, itr_max=3000)
    p = tmp_path / "jacobi.txt"
    res.write_history(p)
    lines = p.read_text().splitlines()
    assert lines[0] == "Itration      Residual"
    assert lines[1].startswith("     1, ")
    assert len(lines) == res.iters + 1


def test_replaced_nonzero_rhs_not_dropped(interpret_kernel):
    """dataclasses.replace(prob, rhs=nonzero) keeps the stale
    rhs_inner_zero hint; the red-black kernel (b_is_zero form) must not
    trust it and silently solve the Laplace problem instead."""
    import dataclasses

    prob0 = Problem.poisson_cube(16)
    prob = dataclasses.replace(prob0, rhs=prob0.rhs + 5.0 * prob0.msk)
    assert prob.rhs_inner_zero  # the stale hint survives replace
    assert not prob.rhs_is_inner_zero()
    rp = solve(prob, "sor2sma", omega=1.5, itr_max=4000, impl="pallas")
    rj = solve(prob, "sor2sma", omega=1.5, itr_max=4000, impl="jnp")
    assert rp.iters == rj.iters
    np.testing.assert_allclose(
        np.asarray(rp.x), np.asarray(rj.x), rtol=1e-5, atol=1e-5
    )
