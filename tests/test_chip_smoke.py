"""chip_smoke.py's pieces that run without a card, and its refusal to run
anywhere but on a GPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

import chip_smoke

ROOT = pathlib.Path(chip_smoke.__file__).resolve().parent


@pytest.mark.parametrize(
    "fname,iters",
    [
        ("f32_sor2sma_512_w1.5.txt", 5389),
        ("f32_sor2sma_512_w1.5_planes.txt", 5787),
        ("f64_sor2sma_512_w1.5.txt", 5781),
        ("f32_sor2sma_maf_128_w1.5.txt", 1813),
        ("f32_pcr_rb_128_w1.5.txt", 1356),
        ("f32_pcr_rb_maf_128_w1.5.txt", 1355),
        ("f64_pbicgstab_sor2sma_256_w1.1.txt", 38),
    ],
)
def test_oracle_iters(fname, iters):
    assert chip_smoke.oracle_iters(fname) == iters


def _history(fname):
    rows = (chip_smoke.HIST / fname).read_text().splitlines()[1:]
    return [float(r.split(",")[1]) for r in rows if r.strip()]


def test_512_oracles_differ_only_in_the_residual_sum():
    """The f32 oracle with one float residual partial per j-plane tracks the
    f64 oracle to 0.11% over the whole 512^3 solve; the serial oracle's one
    float accumulator per color falls up to 8% below it.  Both run the same
    f32 field arithmetic, so the serial count (5389) comes from the sum."""
    f64 = _history("f64_sor2sma_512_w1.5.txt")
    planes = _history(chip_smoke.SOR2SMA_512_F32)
    serial = _history("f32_sor2sma_512_w1.5.txt")
    # first sweep: the per-plane sum prints as f64's, the serial one not
    assert planes[0] == f64[0] and serial[0] != f64[0]
    assert max(abs(p - d) / d for p, d in zip(planes, f64)) < 1.1e-3
    assert max(abs(s - d) / d for s, d in zip(serial, f64)) > 0.08


@pytest.mark.parametrize(
    "layout,div,ok",
    [("sharded", (1, 2, 2), True), ("sharded", (2, 2, 2), True),
     ("replicated", (1, 2, 2), False), ("one-device", (1, 2, 2), False)],
)
def test_check_decomposed(layout, div, ok):
    """Only a field split into one distinct block per device passes: a copy
    replicated on every device, or one left on the first, fails."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from cubez_tpu.parallel.mesh import make_mesh

    n = div[0] * div[1] * div[2]
    cm = make_mesh((8, 8, 8), devices=jax.devices()[:n], div=div)
    a = jnp.arange(512.0).reshape(8, 8, 8)
    if layout == "sharded":
        a = cm.shard(a)
    elif layout == "replicated":
        a = jax.device_put(a, NamedSharding(cm.mesh, PartitionSpec()))
    if ok:
        chip_smoke.check_decomposed(a, div, layout)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_decomposed(a, div, layout)


@pytest.mark.parametrize(
    "text,want",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n",
         ("NVIDIA H100 80GB HBM3", "700.00 W")),
        ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 500.00 W\n",
         ("NVIDIA H100 80GB HBM3", "500.00 W")),
        ("  NVIDIA H100 NVL ,  400.00 W  ", ("NVIDIA H100 NVL", "400.00 W")),
    ],
)
def test_parse_smi(text, want):
    assert chip_smoke.parse_smi(text) == want


@pytest.mark.parametrize("text", ["", "no comma here", ", 700 W"])
def test_parse_smi_rejects_garbage(text):
    with pytest.raises((ValueError, IndexError)):
        chip_smoke.parse_smi(text)


@pytest.mark.parametrize("count", [1, 4])
def test_last_line(count):
    line = chip_smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", count)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": count},
    }


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_exits_nonzero_on_the_cpu():
    r = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
