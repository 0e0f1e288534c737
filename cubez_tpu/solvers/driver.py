"""Iteration drivers: the while-loop + convergence logic of cz_Poisson.cpp.

Each driver runs entirely on-device as a single ``lax.while_loop`` under jit:
sweep -> residual reduce -> history append -> Dirichlet re-imposition ->
eps test (the per-iteration skeleton of cz_Poisson.cpp:39-79).  The residual
history lives in a preallocated on-device buffer so there are no host
round-trips inside the loop.

Residual definition (cz_Poisson.cpp:67-71, cz_Evaluate.cpp:222-224):
    res = sqrt( sum(dp^2 over inner) / N_inner ),   stop when res < eps.
The default eps = 1.0e-5 matches cz.h:162.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .dispatch import check_every_default

EPS_DEFAULT = 1.0e-5


@dataclasses.dataclass
class SolveResult:
    x: jax.Array
    iters: int
    res: float
    # residual per iteration, length == iters.  Left on device: the
    # transfer happens only when a consumer touches it (numpy's __array__
    # protocol converts transparently).
    history: "jax.Array | np.ndarray"

    def write_history(self, path):
        """History file with the reference's exact format
        (cz_Evaluate.cpp:217, cz_Poisson.cpp:71); native writer when built."""
        from ..utils.native import write_history

        write_history(path, self.history)


def _res_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


@partial(jax.jit, static_argnames=("step", "itr_max", "apply_bc", "pre", "post"))
def _run_loop(step, x0, b, res_normal, eps, itr_max: int, apply_bc,
              pre=None, post=None):
    """On-device iteration loop.  The per-iteration bookkeeping is minimal:
    the raw sum(dp^2) is compared against eps^2/res_normal (sqrt is
    monotone, so the stopping decision is the same) and the history stores
    r2; the caller converts to residuals once after the loop.

    ``pre``/``post`` fold the step's state-layout converters into this one
    executable (pad x0 and b, unpad the returned field), so the whole
    solve is a single dispatch.  They are static — pass stable
    callables."""
    if pre is not None:
        x0 = pre(x0)
        b = pre(b)
    rdt = _res_dtype()
    hist0 = jnp.zeros((itr_max,), rdt)
    # res >= eps  <=>  r2 >= eps^2 / res_normal
    thresh = (
        jnp.asarray(eps, rdt) * jnp.asarray(eps, rdt)
        / jnp.asarray(res_normal, rdt)
    )

    def cond(state):
        x, itr, r2, hist = state
        return jnp.logical_and(
            itr < itr_max, jnp.logical_or(itr == 0, r2 >= thresh)
        )

    def body(state):
        x, itr, _r2, hist = state
        x, r2 = step(x, b)
        r2 = r2.astype(rdt)
        hist = jax.lax.dynamic_update_index_in_dim(hist, r2, itr, 0)
        if apply_bc is not None:
            x = apply_bc(x)
        return (x, itr + 1, r2, hist)

    state = (x0, jnp.int32(0), jnp.asarray(jnp.inf, rdt), hist0)
    x, itr, r2, hist = jax.lax.while_loop(cond, body, state)
    res_hist = jnp.sqrt(hist * jnp.asarray(res_normal, rdt))
    res = jnp.sqrt(r2 * jnp.asarray(res_normal, rdt))
    if post is not None:
        x = post(x)
    return x, itr, res, res_hist


@partial(jax.jit, static_argnames=("step", "itr_max", "apply_bc", "chunk",
                                   "pre", "post"))
def _run_loop_chunked(step, x0, b, res_normal, eps, itr_max: int, apply_bc,
                      chunk: int, pre=None, post=None):
    """Chunked iteration loop: ``chunk`` sweeps run back-to-back in a
    ``lax.scan`` (no inter-iteration control dependency, so consecutive
    sweep kernels launch back to back), then one convergence check per
    chunk.  The reference's per-iteration check (cz_Poisson.cpp:39-79)
    serializes every iteration behind a scalar decision; here the *decision*
    is chunk-granular but the reported iteration count and residual history
    are bit-identical to per-iteration checking — the exact stopping
    iteration is recovered from the recorded per-sweep residuals after the
    loop.  Only the returned field x runs to the end of the stopping chunk
    (up to chunk-1 extra sweeps, which strictly continue the relaxation)."""
    if pre is not None:
        x0 = pre(x0)
        b = pre(b)
    rdt = _res_dtype()
    # never a chunk longer than the whole run: a rate run (itr_max=3)
    # under a default chunk of 16 would execute 16 sweeps and attribute
    # the wall time to 3 iterations
    chunk = min(chunk, max(itr_max, 1))
    nchunks = -(-itr_max // chunk)
    total = nchunks * chunk
    hist0 = jnp.zeros((total,), rdt)
    thresh = (
        jnp.asarray(eps, rdt) * jnp.asarray(eps, rdt)
        / jnp.asarray(res_normal, rdt)
    )

    def sweep(x, _):
        x, r2 = step(x, b)
        if apply_bc is not None:
            x = apply_bc(x)
        return x, r2.astype(rdt)[None]

    def cond(state):
        _x, done, hist, hit = state
        return jnp.logical_and(done < total, jnp.logical_not(hit))

    def body(state):
        x, done, hist, _hit = state
        x, r2s = jax.lax.scan(sweep, x, None, length=chunk)
        r2s = r2s.reshape(-1)
        hist = jax.lax.dynamic_update_slice(hist, r2s, (done,))
        return (x, done + chunk, hist, jnp.any(r2s < thresh))

    state = (x0, jnp.int32(0), hist0, jnp.bool_(False))
    x, done, hist, _hit = jax.lax.while_loop(cond, body, state)

    # exact stopping iteration: first sweep with r2 < thresh, else itr_max.
    # The final chunk may overshoot itr_max (total is rounded up to whole
    # chunks); those extra sweeps must not count as executed iterations or
    # the chunked loop could report iters > itr_max where the per-iteration
    # loop stops unconverged at itr_max.
    ran = jax.lax.iota(jnp.int32, total) < jnp.minimum(done, itr_max)
    below = jnp.logical_and(hist < thresh, ran)
    itr = jnp.where(
        jnp.any(below),
        jnp.argmax(below).astype(jnp.int32) + 1,
        jnp.minimum(done, itr_max),
    )
    res_hist = jnp.sqrt(hist * jnp.asarray(res_normal, rdt))
    res = res_hist[jnp.maximum(itr - 1, 0)]
    if post is not None:
        x = post(x)
    return x, itr, res, res_hist


def run_iterative(
    step,
    x0,
    b,
    res_normal: float,
    itr_max: int,
    eps: float = EPS_DEFAULT,
    apply_bc=None,
    check_every: int | None = None,
    pre=None,
    post=None,
) -> SolveResult:
    """Run a relaxation/line solver to convergence.

    ``apply_bc`` mirrors the per-iteration bc_k_ call (cz_Poisson.cpp:74);
    with masked sweeps it is mathematically a no-op on a single block, so the
    default skips it.

    ``check_every`` sets the convergence-check granularity (see
    _run_loop_chunked).  None = the step's own hint or the backend's
    measured default (solvers/dispatch.py).  Iteration counts and
    histories are identical either way; with chunking the returned field
    has run to the end of the stopping chunk.
    """
    if check_every is None:
        check_every = check_every_default(step)
    if check_every > 1:
        x, itr, res, hist = _run_loop_chunked(
            step, x0, b, float(res_normal), float(eps), int(itr_max),
            apply_bc, int(check_every), pre, post,
        )
    else:
        x, itr, res, hist = _run_loop(
            step, x0, b, float(res_normal), float(eps), int(itr_max),
            apply_bc, pre, post,
        )
    # one batched host transfer for the scalars
    iters, res_v = jax.device_get((itr, res))
    iters = int(iters)
    return SolveResult(
        x=x, iters=iters, res=float(res_v), history=hist[:iters]
    )


def fixed_sweeps(step, x, b, count: int):
    """``count`` sweeps without convergence checks — the preconditioner mode
    (converge_check=false path of cz_Poisson.cpp:66,280)."""

    def body(_, xx):
        xx, _r2 = step(xx, b)
        return xx

    return jax.lax.fori_loop(0, count, body, x)
