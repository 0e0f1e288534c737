"""The one place that decides which step runs.

Every solver has a plain jnp step that XLA compiles for any backend.  One
hand-written kernel exists: the red-black point sweep in Pallas through
Triton (pallas_kernels/rbsweep.py), which compiles only for a GPU.  This
module decides, from the backend, the dtype, the solver kind, the mask
and the sharding, whether that kernel runs, and how often the convergence
loop checks its stopping test.

``impl`` is the caller's request:

* ``"auto"``: the kernel where it is eligible and measured faster;
* ``"pallas"``: the kernel, or a ValueError where it cannot run (any
  backend other than the GPU, or a configuration it does not cover);
* ``"jnp"``: the plain XLA step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

IMPLS = ("auto", "pallas", "jnp")

# The kernel runs the stand-alone red-black solve (sor2sma, sor2sma_maf),
# where it beat the XLA step end to end on an H100: 2.9x at 512^3, 1.5x at
# 128^3 (PERF.md, "Hand-written kernels against XLA").  It lost 3-8% as
# the BiCGSTAB preconditioner (128^3, 256^3) and as the multigrid smoother
# (256^3): each use packs and unpacks the field around a few sweeps, and
# without the residual XLA fuses the jnp sweeps into fewer passes.  Those
# roles run the jnp sweeps.  The kernel won at both sizes, one of which
# (128^3) sits in the 50 MB L2, so no grid size is excluded.
KERNEL_KINDS = ("sor2sma",)

# Convergence-check cadence of run_iterative per backend (iterations per
# while-loop trip; counts and histories do not depend on it).  On an H100
# 16 beat 1 for both steps: sor2sma 128^3 jnp 0.062 vs 0.092 s, kernel
# 0.040 vs 0.061 s; 512^3 jnp 12.50 vs 12.57 s, kernel 4.31 vs 4.37 s.
CHECK_EVERY = {"gpu": 16}


def backend() -> str:
    return jax.default_backend()


def is_sharded(x) -> bool:
    """True for an array spread over more than one device."""
    if getattr(x, "is_fully_addressable", True) is False:
        return True
    sh = getattr(x, "sharding", None)
    return getattr(sh, "num_devices", 1) > 1


def use_rb_kernel(
    kind: str,
    dtype,
    *,
    impl: str = "auto",
    sharded: bool = False,
    standard_mask: bool = True,
) -> bool:
    """Whether the red-black Triton kernel runs the solve of solver kind
    ``kind`` (canonical, from steps.parse_name)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "jnp":
        return False
    eligible = (
        kind in KERNEL_KINDS
        and jnp.dtype(dtype) == jnp.float32
        and not sharded
        and standard_mask
    )
    if impl == "pallas":
        if backend() != "gpu":
            raise ValueError(
                "impl='pallas' runs the red-black Triton kernel, which "
                f"compiles only for a GPU (backend: {backend()!r})"
            )
        if not eligible:
            raise ValueError(
                "impl='pallas': the red-black kernel covers the sor2sma "
                "solve in float32 on one device with the standard cube "
                f"mask; not {kind!r} in {jnp.dtype(dtype).name}"
                + (" sharded" if sharded else "")
                + ("" if standard_mask else " with a custom mask")
            )
        return True
    return eligible and backend() == "gpu"


def check_every_default(step=None) -> int:
    """The loop's check cadence: a step's own hint (wavefront and V-cycle
    steps carry one), else the backend's measured default, else 1."""
    hint = getattr(step, "check_every_default", None)
    return hint or CHECK_EVERY.get(backend(), 1)
