"""Smoke run of the solvers on the GPU, through the entry points users call.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # four cards: the decomposition only

One card runs four phases, each of which must pass:

1. device      JAX's backend is the GPU; prints its kind and
               ``nvidia-smi --query-gpu=name,power.limit``;
2. main path   sor2sma 512^3 f32 (BASELINE config 5's grid) through
               ``cubez_tpu.solve`` and through the CLI, and in f64 through
               ``cubez_tpu.solve``, each count equal to its oracle's, with
               the wall time printed (compile excluded);
3. kernels     the red-black Triton kernel against the jnp step at 128^3
               and 512^3, constant and MAF, after 1 and 50 sweeps, and on
               a non-cubic odd grid with a nonzero RHS;
4. breadth     sor2sma_maf and pcr_rb 128^3, mg and fmg 256^3, fd 256^3 and
               pbicgstab+sor2sma 256^3 f64 (BASELINE config 4), each checked
               against its oracle count or tolerance.

``--four-cards`` runs only the decomposed solves over a four-device mesh
and checks them against the oracle and the one-card run.

Any failure exits non-zero; on success the last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero before any solve.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys
import time

HIST = pathlib.Path(__file__).resolve().parent / "tests" / "ref_histories"

# sor2sma 512^3 omega=1.5 oracles (tests/ref_histories/README.md).  The f32
# solve is held to the oracle run with one float residual partial per
# j-plane: the serial oracle's single float accumulator per color
# (f32_sor2sma_512_w1.5.txt, 5389) undercounts a sum of 6.6e7 terms, which a
# reduction tree does not.  The f64 solve is held to the f64 oracle.
SOR2SMA_512_F32 = "f32_sor2sma_512_w1.5_planes.txt"
SOR2SMA_512_F64 = "f64_sor2sma_512_w1.5.txt"

# kernel parity limits: |field| <= 1, so 1e-6 is ~8 ulp of f32 (FMA
# contraction, division rounding); the residual's partial sums are added
# in another order
MAX_DX = 1e-6
MAX_R2_REL = 1e-5


def oracle_iters(fname: str) -> int:
    """Iteration count of a checked-in oracle history (header + one row
    per iteration)."""
    rows = (HIST / fname).read_text().splitlines()[1:]
    return sum(1 for r in rows if r.strip())


def parse_smi(text: str) -> tuple[str, str]:
    """(name, power limit) of the first card in
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    line = text.strip().splitlines()[0]
    name, limit = (f.strip() for f in line.rsplit(",", 1))
    if not name or not limit:
        raise ValueError(f"unexpected nvidia-smi output: {text!r}")
    return name, limit


def last_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True,
         "device": {"platform": platform, "kind": kind, "count": count}}
    )


def check_decomposed(a, div, what: str):
    """``a`` is split over the mesh ``div`` = (z, x, y): one distinct block
    per device, each the global shape divided by ``div`` -- not a copy
    replicated on every device, and not everything on the first one."""
    shards = a.addressable_shards
    want = tuple(n // d for n, d in zip(a.shape, div))
    n_dev = div[0] * div[1] * div[2]
    blocks = {tuple((s.start, s.stop) for s in sh.index) for sh in shards}
    ok = (
        not a.sharding.is_fully_replicated
        and len({sh.device.id for sh in shards}) == n_dev
        and len(blocks) == n_dev
        and all(sh.data.shape == want for sh in shards)
    )
    check(ok, f"{what}: {n_dev} distinct blocks of {want} on "
          f"{len({sh.device.id for sh in shards})} devices")


def log(msg: str):
    print(msg, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)
    log(f"  ok: {msg}")


def timed(fn):
    """(result, seconds) of fn() with the result's field ready."""
    import jax

    t0 = time.perf_counter()
    r = fn()
    jax.block_until_ready(r.x)
    return r, time.perf_counter() - t0


# ---- phases ----------------------------------------------------------------


def phase_device():
    import jax

    log("== device")
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX's backend is "
            f"{jax.default_backend()!r}"
        )
    d = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    name, limit = parse_smi(smi)
    log(f"device_kind: {d.device_kind}; devices: {len(jax.devices())}")
    log(f"nvidia-smi: {name}, {limit}")
    return d


def phase_main_path():
    import jax.numpy as jnp

    import cubez_tpu as cz
    from cubez_tpu import cli

    log("== main path: sor2sma 512^3, omega 1.5")
    log("serial f32 oracle (one float accumulator per color, not the "
        f"target): {oracle_iters('f32_sor2sma_512_w1.5.txt')}")
    for dt, fname in ((jnp.float32, SOR2SMA_512_F32),
                      (jnp.float64, SOR2SMA_512_F64)):
        name = jnp.dtype(dt).name
        want = oracle_iters(fname)
        prob = cz.Problem.poisson_cube(512, dtype=dt)
        _, t_warm = timed(lambda: cz.solve(prob, "sor2sma", omega=1.5,
                                           itr_max=10000, eps=1e9))
        r, t = timed(lambda: cz.solve(prob, "sor2sma", omega=1.5,
                                      itr_max=10000))
        log(f"cz.solve {name}: {r.iters} iterations, res {r.res:.6e}, wall "
            f"{t:.3f} s (compile + one iteration before: {t_warm:.3f} s), "
            f"{prob.grid.num_inner * r.iters / t / 1e9:.3f} Gcells/s")
        check(r.iters == want and r.res < 1e-5,
              f"cz.solve {name} iterations {r.iters} == oracle {want}")

    out = io.StringIO()
    argv = ["512", "512", "512", "sor2sma", "10000", "1.5", "--warmup"]
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    text = out.getvalue()
    for ln in text.splitlines():
        if ln.startswith(("Iter =", "wall =", "Error max")):
            log(f"cli: {ln}")
    m = re.search(r"Iter = (\d+)", text)
    check(rc == 0 and m is not None, "cli ran")
    want = oracle_iters(SOR2SMA_512_F32)
    check(int(m.group(1)) == want,
          f"cli iterations {m.group(1)} == oracle {want}")


def phase_kernels():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from cubez_tpu import Problem
    from cubez_tpu.pallas_kernels import rbsweep
    from cubez_tpu.solvers.steps import make_step

    log("== kernels: red-black Triton sweep against the jnp step "
        f"(f32; limits max|dx| <= {MAX_DX:g}, r2 rel <= {MAX_R2_REL:g})")
    # (ni, nj, nk), MAF, nonzero RHS: the solve's cubes, then a non-cubic
    # grid with odd I (one padding row) and the RHS the kernel reads
    cases = [(n, maf, False) for n in (128, 512) for maf in (False, True)]
    cases += [((127, 129, 65), False, True), ((127, 129, 65), True, True)]
    for n, maf, with_b in cases:
        prob = Problem.poisson_cube(n, dtype=jnp.float32, maf=maf)
        if with_b:
            b = 0.1 * jax.random.normal(
                jax.random.PRNGKey(0), prob.x0.shape, jnp.float32
            ) * prob.msk
            prob = dataclasses.replace(prob, rhs=b, rhs_inner_zero=False)
        name = "sor2sma_maf" if maf else "sor2sma"
        label = f"{name} {'x'.join(map(str, prob.grid.shape_kij))}" + (
            " b!=0" if with_b else "")
        ref = jax.jit(make_step(prob, name, 1.5))
        kstep = rbsweep.make_rb_step(
            prob.grid.shape_kij, jnp.float32, omega=1.5,
            mc=prob.mc if maf else None, b_is_zero=not with_b,
        )
        run = jax.jit(kstep)
        unpad = jax.jit(kstep.unpad)
        p = jax.jit(kstep.pad)(prob.x0)
        bp = jax.jit(kstep.pad)(prob.rhs)
        x = prob.x0
        for it in range(1, 51):
            p, r2k = run(p, bp)
            x, r2j = ref(x, prob.rhs)
            if it in (1, 50):
                dx = float(jnp.max(jnp.abs(unpad(p) - x)))
                rel = abs(float(r2k) - float(r2j)) / float(r2j)
                log(f"  {label} after {it:2d} sweeps: max|dx| {dx:.3e}, "
                    f"r2 rel {rel:.3e}")
                check(dx <= MAX_DX and rel <= MAX_R2_REL,
                      f"{label} sweep {it} within limits")
        del p, bp, x


def phase_breadth():
    import jax.numpy as jnp

    import cubez_tpu as cz

    log("== breadth")
    cases = [
        ("sor2sma_maf", 128, jnp.float32, 1.5, None,
         "f32_sor2sma_maf_128_w1.5.txt", 1e-5),
        ("pcr_rb", 128, jnp.float32, 1.5, None,
         "f32_pcr_rb_128_w1.5.txt", 1e-5),
        ("pbicgstab", 256, jnp.float64, 1.1, "sor2sma",
         "f64_pbicgstab_sor2sma_256_w1.1.txt", 1e-5),
    ]
    for solver, n, dt, om, pre, fname, eps in cases:
        prob = cz.Problem.poisson_cube(n, dtype=dt, maf=solver.endswith("_maf"))
        r, t = timed(lambda: cz.solve(prob, solver, omega=om, itr_max=20000,
                                      eps=eps, precond=pre))
        want = oracle_iters(fname)
        log(f"{solver}{'+' + pre if pre else ''} {n}^3 "
            f"{jnp.dtype(dt).name}: {r.iters} iterations, res {r.res:.3e}, "
            f"{t:.3f} s with compile; oracle {want}")
        check(r.iters == want and r.res < eps,
              f"{solver} {n}^3 == oracle {want}")
    for solver in ("mg", "fmg"):
        prob = cz.Problem.poisson_cube(256, dtype=jnp.float32)
        r, t = timed(lambda: cz.solve(prob, solver, omega=1.0, itr_max=50))
        log(f"{solver} 256^3 f32: {r.iters} cycles, res {r.res:.3e}, "
            f"{t:.3f} s with compile")
        check(r.res < 1e-5, f"{solver} 256^3 converged")
    prob = cz.Problem.poisson_cube(256, dtype=jnp.float32)
    r, t = timed(lambda: cz.solve(prob, "fd", omega=1.0, itr_max=4,
                                  eps=1e-6))
    log(f"fd 256^3 f32: {r.iters} iteration(s), res {r.res:.3e}, "
        f"{t:.3f} s with compile")
    check(r.iters == 1 and r.res < 1e-6, "fd 256^3 exact in one iteration")


def phase_four_cards():
    import dataclasses

    import jax
    import jax.numpy as jnp

    import cubez_tpu as cz
    from cubez_tpu.parallel.api import solve_dist
    from cubez_tpu.parallel.dist import make_dist_step
    from cubez_tpu.parallel.mesh import make_mesh

    log("== four cards")
    devs = jax.devices()
    check(len(devs) == 4, f"{len(devs)} devices == 4")

    prob = cz.Problem.poisson_cube(512, dtype=jnp.float32)
    cm = make_mesh(prob.grid.shape_kij)
    log(f"mesh division (z, x, y) = {cm.div}")
    x0, b = cm.shard(prob.x0), cm.shard(prob.rhs)
    check_decomposed(x0, cm.div, "sharded x0 (512^3)")
    # the state the solve's loop carries, after one step of it
    step = make_dist_step(prob, cm, "sor2sma", 1.5, sync="color")
    x1, _ = jax.jit(step)(x0, b)
    check_decomposed(x1, cm.div, "loop state after one step")
    del x0, b, x1
    run = lambda eps: solve_dist(prob, cm, "sor2sma", omega=1.5,  # noqa: E731
                                 itr_max=10000, eps=eps, sync="color")
    timed(lambda: run(1e9))
    r, t = timed(lambda: run(1e-5))
    log(f"solve_dist sor2sma 512^3 sync=color: {r.iters} iterations, "
        f"res {r.res:.6e}, wall {t:.3f} s (compile excluded)")
    check_decomposed(r.x, cm.div, "solution field")
    one = cz.solve(prob, "sor2sma", omega=1.5, itr_max=10000)
    want = oracle_iters(SOR2SMA_512_F32)
    log(f"one card (device {one.x.devices()}): {one.iters} iterations")
    check(r.iters == one.iters == want,
          f"iterations {r.iters} == one card's {one.iters} == oracle {want}")
    del one, r

    p128 = cz.Problem.poisson_cube(128, dtype=jnp.float32, maf=True)
    cm_k = make_mesh(p128.grid.shape_kij, div=(1, 2, 2))  # K unsplit
    r, t = timed(lambda: solve_dist(p128, cm_k, "pcr_rb_maf", omega=1.5,
                                    itr_max=10000))
    want = oracle_iters("f32_pcr_rb_maf_128_w1.5.txt")
    log(f"pcr_rb_maf 128^3 mesh {cm_k.div}: {r.iters} iterations "
        f"(oracle {want}), {t:.3f} s with compile")
    check_decomposed(r.x, cm_k.div, "pcr_rb_maf field")
    check(abs(r.iters - want) <= 2, f"pcr_rb_maf within 2 of {want}")

    p64 = cz.Problem.poisson_cube(256, dtype=jnp.float64)
    cm256 = make_mesh(p64.grid.shape_kij)
    r, t = timed(lambda: solve_dist(p64, cm256, "pbicgstab", omega=1.1,
                                    itr_max=4000, precond="sor2sma"))
    want = oracle_iters("f64_pbicgstab_sor2sma_256_w1.1.txt")
    log(f"pbicgstab+sor2sma 256^3 f64 mesh {cm256.div}: {r.iters} "
        f"iterations (oracle {want}), res {r.res:.3e}, {t:.3f} s")
    check_decomposed(r.x, cm256.div, "pbicgstab field")
    check(abs(r.iters - want) <= 1, f"pbicgstab within 1 of {want}")

    pmg = cz.Problem.poisson_cube(256, dtype=jnp.float32)
    rs = cz.solve(pmg, "mg", omega=1.0, itr_max=50)
    psh = dataclasses.replace(
        pmg, x0=cm256.shard(pmg.x0), rhs=cm256.shard(pmg.rhs),
        msk=cm256.shard(pmg.msk),
    )
    rd, t = timed(lambda: cz.solve(psh, "mg", omega=1.0, itr_max=50))
    log(f"mg 256^3: sharded {rd.iters} cycles (res {rd.res:.3e}), "
        f"one card {rs.iters}")
    check_decomposed(rd.x, cm256.div, "mg field")
    check(rd.iters == rs.iters and rd.res < 1e-5,
          "sharded mg cycles == one-card cycles")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the four-card decomposition phase only")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    import cubez_tpu  # noqa: F401  (fails here when run outside the repo)
    from cubez_tpu.utils import compile_cache

    dev = phase_device()
    log(f"compile cache: {compile_cache.enable()}")
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_main_path()
        phase_kernels()
        phase_breadth()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(last_line(dev.platform, dev.device_kind, len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
