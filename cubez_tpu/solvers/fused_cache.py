"""Caches of built steps and Krylov runners.

Steps are Python closures; ``jax.jit`` keys its trace cache on the
closure's identity, so rebuilding a step per solve() call forces a full
re-trace and recompile every time.  These caches return the same object
for the same problem and parameters, so repeated solves reuse the
compiled executable.  Entries are keyed by the problem object's identity
and keep a strong reference to it, so the key stays valid.
"""

from __future__ import annotations


def _cached(cache: dict, problem, key, build):
    ent = cache.get(key)
    if ent is not None and ent[0] is problem:
        return ent[1]
    value = build()
    cache[key] = (problem, value)
    return value


_BICG_CACHE: dict = {}


def get_bicgstab(problem, solver: str, omega: float, precond):
    """Build-or-fetch the jitted BiCGSTAB runner for this problem object."""
    from .bicgstab import make_bicgstab

    key = (id(problem), solver, float(omega), precond)
    return _cached(
        _BICG_CACHE, problem, key,
        lambda: make_bicgstab(problem, solver, omega, precond),
    )


def get_cg(problem, omega: float, precond):
    """Build-or-fetch the jitted CG runner (the shared cache is keyed by
    solver name)."""
    from .cg import make_cg

    key = (id(problem), "cg", float(omega), precond)
    return _cached(
        _BICG_CACHE, problem, key, lambda: make_cg(problem, omega, precond)
    )


_STEP_CACHE: dict = {}


def get_jnp_step(problem, solver: str, omega: float):
    """Build-or-fetch the jnp (XLA) step for this problem object."""
    from .steps import make_step

    key = (id(problem), solver, float(omega))
    return _cached(
        _STEP_CACHE, problem, key, lambda: make_step(problem, solver, omega)
    )


def get_rb_step(problem, solver: str, omega: float):
    """Build-or-fetch the red-black Triton kernel step for this problem
    object, with its layout converters attached as ``_pre`` / ``_post``
    (stable identities, so the loop's jit reuses its executable)."""
    from ..pallas_kernels import rbsweep
    from .steps import _named, parse_name

    def build():
        _, is_maf = parse_name(solver)
        if is_maf and problem.mc is None:
            raise ValueError("MAF solver requested but Problem has no MafCoeffs")
        g = problem.grid
        kstep = rbsweep.make_rb_step(
            g.shape_kij, g.dtype, omega=omega,
            mc=problem.mc if is_maf else None,
            b_is_zero=problem.rhs_is_inner_zero(),
        )
        step = _named(solver, kstep)
        step._pre, step._post = kstep.pad, kstep.unpad
        return step

    key = (id(problem), solver, float(omega), "rb")
    return _cached(_STEP_CACHE, problem, key, build)
