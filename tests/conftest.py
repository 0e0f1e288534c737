"""Test configuration: run on an 8-virtual-device CPU mesh.

Multi-chip logic (shard_map + ppermute/psum) is validated on the CPU exactly
as the dry run does.  What needs a GPU (the red-black Triton kernel compiled
for the card) is checked by ``python chip_smoke.py`` on the card; here the
same kernel runs in the Pallas interpreter through the ``interpret_kernel``
fixture below.  Tests that need the card itself carry the ``gpu`` marker and
skip through the ``gpu_device`` fixture where there is none; on the card
``pytest -m gpu tests/`` runs them on the default backend (the one
selection that is not pinned to the CPU).
"""

import os

# Must be set before jax initializes its backends.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# Test tiers: the names below (bare function names; parametrized variants
# inherit) are the long to-tolerance/parity runs — each >= ~17 s on the
# shared 4-core host, together ~85% of the suite's 45 minutes.  They carry
# redundant signal at small scale, so the fast tier for iteration is
#     pytest -m "not slow" tests/        (~5 min)
# and CI/verify runs the full suite.  Tests already marked slow in-file
# (pytest.mark.slow) are unaffected.
import pytest  # noqa: E402

_SLOW_TESTS = {
    "test_fmg_dist_matches_serial",
    "test_fmg_beats_mg_to_tolerance",
    "test_dist_maf_line_matches_serial_unsplit_k",
    "test_fmg_init_alone_reaches_discretization_error",
    "test_fmg_as_precond_maps_to_one_vcycle",
    "test_dist_maf_matches_serial",
    "test_dist_pcr_unsplit_k_matches_serial",
    "test_dist_sor2sma_matches_serial",
    "test_mg_dist_matches_serial",
    "test_mg_grid_independent_cycles_and_contraction",
    "test_bicgstab_mg_precond",
    "test_dist_jacobi_matches_serial",
    "test_mg_converges_fast_any_size",
    "test_mg_eps_1e6",
    "test_fmg_rejects_custom_x0",
    "test_mg_solution_accuracy",
    "test_mg_history_semantics",
    "test_maf_stretched_h2_convergence",
    "test_solve_dist_total_all_solvers",
    "test_fmg_maf",
    # re-tiered after a --durations pass
    "test_sharded_checkpoint_resume_matches_straight",
}


def pytest_configure(config):
    # before any backend starts: every selection but ``-m gpu`` runs on the
    # CPU mesh, even on a machine with a card
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Let solve() and its helpers pick the red-black Triton kernel on the
    CPU and run it in the Pallas interpreter: the dispatcher sees a GPU
    backend and every build of the kernel gets ``interpret=True``."""
    from cubez_tpu.pallas_kernels import rbsweep
    from cubez_tpu.solvers import dispatch

    build = rbsweep.make_rb_step
    monkeypatch.setattr(dispatch, "backend", lambda: "gpu")
    monkeypatch.setattr(
        rbsweep, "make_rb_step",
        lambda *a, **k: build(*a, **{**k, "interpret": True}),
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none (decided
    here, at run time, never while the module is imported)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU; on the card run pytest -m gpu tests/")
    return devs[0]
