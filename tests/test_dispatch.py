"""The step chooser (solvers/dispatch.py), the peaks table, the compile-cache
helper and the int32 mask count: the pieces that decide how the program
runs on a card, checked on the CPU by steering what they observe."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cubez_tpu import Problem, solve
from cubez_tpu.solvers import dispatch

F32, F64 = jnp.float32, jnp.float64


@pytest.fixture
def on_backend(monkeypatch):
    def set_backend(name):
        monkeypatch.setattr(dispatch, "backend", lambda: name)

    return set_backend


# (backend, kind, dtype, sharded, standard mask) -> auto choice
AUTO_CASES = [
    ("gpu", "sor2sma", F32, False, True, True),
    ("gpu", "sor2sma", F64, False, True, False),
    ("gpu", "sor2sma", F32, True, True, False),
    ("gpu", "sor2sma", F32, False, False, False),
    ("gpu", "jacobi", F32, False, True, False),
    ("gpu", "pcr_rb", F32, False, True, False),
    ("gpu", "psor", F32, False, True, False),
    ("gpu", "mg", F32, False, True, False),
    ("gpu", "pbicgstab", F32, False, True, False),
    ("cpu", "sor2sma", F32, False, True, False),
    ("rocm", "sor2sma", F32, False, True, False),
]


@pytest.mark.parametrize("backend,kind,dtype,sharded,std,want", AUTO_CASES)
def test_auto_choice(on_backend, backend, kind, dtype, sharded, std, want):
    on_backend(backend)
    got = dispatch.use_rb_kernel(kind, dtype, impl="auto", sharded=sharded,
                                 standard_mask=std)
    assert got is want


@pytest.mark.parametrize("kind", ["sor2sma", "jacobi", "mg"])
def test_jnp_never_picks_the_kernel(on_backend, kind):
    on_backend("gpu")
    assert not dispatch.use_rb_kernel(kind, F32, impl="jnp")


def test_pallas_forces_the_kernel_on_gpu(on_backend):
    on_backend("gpu")
    assert dispatch.use_rb_kernel("sor2sma", F32, impl="pallas")


@pytest.mark.parametrize("backend", ["cpu", "rocm", "metal"])
def test_pallas_off_gpu_raises(on_backend, backend):
    on_backend(backend)
    with pytest.raises(ValueError, match="compiles only for a GPU"):
        dispatch.use_rb_kernel("sor2sma", F32, impl="pallas")


@pytest.mark.parametrize(
    "kind,dtype,sharded,std",
    [("jacobi", F32, False, True), ("mg", F32, False, True),
     ("pbicgstab", F32, False, True), ("sor2sma", F64, False, True),
     ("sor2sma", F32, True, True), ("sor2sma", F32, False, False)],
)
def test_pallas_on_gpu_raises_where_the_kernel_cannot_run(
    on_backend, kind, dtype, sharded, std
):
    on_backend("gpu")
    with pytest.raises(ValueError, match="red-black kernel covers"):
        dispatch.use_rb_kernel(kind, dtype, impl="pallas", sharded=sharded,
                               standard_mask=std)


@pytest.mark.parametrize("impl", ["fused", "triton"])
def test_unknown_impl_raises(impl):
    with pytest.raises(ValueError, match="impl"):
        dispatch.use_rb_kernel("sor2sma", F32, impl=impl)


def test_solve_with_pallas_on_cpu_raises():
    prob = Problem.poisson_cube(8)
    with pytest.raises(ValueError, match="compiles only for a GPU"):
        solve(prob, "sor2sma", omega=1.5, itr_max=5, impl="pallas")


def test_solve_auto_on_cpu_runs_the_jnp_step():
    prob = Problem.poisson_cube(16)
    ra = solve(prob, "sor2sma", omega=1.5, itr_max=1000)
    rj = solve(prob, "sor2sma", omega=1.5, itr_max=1000, impl="jnp")
    assert ra.iters == rj.iters
    np.testing.assert_array_equal(np.asarray(ra.x), np.asarray(rj.x))


@pytest.mark.parametrize(
    "solver,precond", [("cg", "jacobi"), ("pbicgstab", "sor2sma"),
                       ("mg", None)],
)
def test_pallas_without_a_kernel_raises_on_gpu(on_backend, solver, precond):
    on_backend("gpu")
    prob = Problem.poisson_cube(8)
    with pytest.raises(ValueError, match="red-black kernel covers"):
        solve(prob, solver, omega=1.0, itr_max=5, precond=precond,
              impl="pallas")


def test_cli_rejects_pallas_on_a_mesh(capsys):
    from cubez_tpu.cli import main

    rc = main(["8", "8", "8", "sor2sma", "5", "1.5", "1", "1", "2",
               "--impl", "pallas"])
    assert rc == 2
    assert "no distributed kernel" in capsys.readouterr().err


@pytest.mark.parametrize(
    "backend,hint,want", [("gpu", None, 16), ("cpu", None, 1),
                          ("rocm", None, 1), ("gpu", 2, 2), ("cpu", 2, 2)],
)
def test_check_every_default(on_backend, backend, hint, want):
    on_backend(backend)

    def step(x, b):
        return x, 0.0

    if hint is not None:
        step.check_every_default = hint
    assert dispatch.check_every_default(step) == want


# ---- peaks table -----------------------------------------------------------


class _Dev:
    def __init__(self, platform, kind):
        self.platform, self.device_kind = platform, kind


@pytest.mark.parametrize(
    "kind,gbps",
    [("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 2000.0),
     ("NVIDIA H100 NVL", 3900.0)],
)
def test_known_h100_kinds_resolve(kind, gbps):
    from cubez_tpu.perf.pmlib import device_peaks

    peaks = device_peaks(_Dev("gpu", kind))
    assert peaks["hbm_gbps"] == gbps and peaks["f32_tflops"] > 0


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB",
                                  "AMD Instinct MI300X"])
def test_unknown_accelerator_raises(kind):
    from cubez_tpu.perf.pmlib import device_peaks

    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(_Dev("gpu", kind))


def test_cpu_has_no_peak():
    from cubez_tpu.perf.pmlib import PerfMonitor, device_peaks

    assert device_peaks() is None  # the test backend is the CPU
    pm = PerfMonitor(hbm_gbps=None)
    pm.add("sweep", 1.0, bytes=1e9, flops=1e9)
    row = [ln for ln in pm.report().splitlines() if ln.startswith("sweep")][0]
    assert row.rstrip().endswith("1.0")  # GB/s column last: no %SoL


# ---- compile cache ---------------------------------------------------------


def test_compile_cache_env_set_is_left_alone(monkeypatch, tmp_path):
    from cubez_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert calls == []


def test_compile_cache_unset_uses_fixed_checkout_path(monkeypatch):
    from cubez_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(
        compile_cache.__file__)))
    assert path == os.path.join(os.path.dirname(checkout), ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert compile_cache.enable() == path  # same path every time


# ---- standard-mask check ---------------------------------------------------


def test_mask_count_exact_above_2_pow_24():
    """260^3 has 258^3 = 17,173,512 inner nodes, above 2^24: the count is
    taken in int32, so a copy of the standard mask is recognised and a
    single flipped node is not."""
    prob = Problem.poisson_cube(260)
    assert prob.grid.num_inner > 2**24
    copy = dataclasses.replace(prob, msk=prob.msk + 0.0)
    assert copy.msk is not prob.grid.inner_mask
    assert copy.msk_is_standard()
    hole = dataclasses.replace(prob, msk=prob.msk.at[100, 100, 100].set(0.0))
    assert not hole.msk_is_standard()


@pytest.mark.parametrize("where", ["shell", "value"])
def test_mask_check_pins_values(where):
    prob = Problem.poisson_cube(12)
    m = prob.msk + 0.0
    m = m.at[0, 5, 5].set(1.0) if where == "shell" else m.at[5, 5, 5].set(2.0)
    assert not dataclasses.replace(prob, msk=m).msk_is_standard()


# ---- cli and cost model ----------------------------------------------------


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_cli_platform_choices(platform):
    from cubez_tpu.cli import build_argparser

    args = build_argparser().parse_args(
        ["8", "8", "8", "sor2sma", "10", "1.5", "--platform", platform]
    )
    assert args.platform == platform


def test_cli_rejects_unknown_platform():
    from cubez_tpu.cli import build_argparser

    with pytest.raises(SystemExit):
        build_argparser().parse_args(
            ["8", "8", "8", "sor2sma", "10", "1.5", "--platform", "metal"]
        )


@pytest.mark.parametrize("name", ["pcr", "pcr_rb", "pcr_rb_maf"])
def test_pcr_cost_uses_reference_accounting(name):
    from cubez_tpu.perf.roofline import pcr_flops_per_pt, sweep_cost

    shape = (128, 64, 64)
    f, b = sweep_cost(name, shape)
    n = shape[0] * shape[1] * shape[2]
    assert f == pcr_flops_per_pt(126) * n
    assert b == 3 * n * 4
    assert sweep_cost(name, shape, b_is_zero=True)[1] == 2 * n * 4
