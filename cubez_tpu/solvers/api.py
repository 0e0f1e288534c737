"""Top-level solve API — the equivalent of CZ::Evaluate's solver dispatch
(cz_Evaluate.cpp:414-489) as a function.

    result = solve(Problem.poisson_cube(64), "sor2sma", omega=1.5,
                   itr_max=10000)
"""

from __future__ import annotations

from typing import Optional

import jax

from ..core.problem import Problem
from . import dispatch
from . import steps as steps_mod
from .driver import EPS_DEFAULT, SolveResult, run_iterative

SOLVERS = steps_mod.ALL_SOLVERS


def _initial_x(step, problem: Problem):
    """The solve's starting iterate: ``problem.x0`` normally; steps that
    carry an ``fmg_init`` (full multigrid, solvers/multigrid.py) derive it
    from the RHS with one F-cycle instead.  The jitted initializer is
    cached on the step so repeated solves reuse the executable.

    The F-cycle keeps x0's boundary shell (it becomes the per-level
    Dirichlet data) but DISCARDS x0's interior (derived from the RHS
    instead), so silently accepting an x0 with interior state — a
    checkpoint restart — would throw the caller's state away; reject
    those (``mg`` honors x0)."""
    init = getattr(step, "fmg_init", None)
    if init is None:
        return problem.x0
    if not getattr(step, "_fmg_x0_checked", False):
        import numpy as np

        if np.any(np.asarray(problem.x0 * problem.msk)):
            raise ValueError(
                "fmg derives its initial interior from the RHS and would "
                "discard this problem's x0 interior; use 'mg' to iterate "
                "from a custom or restarted x0"
            )
        step._fmg_x0_checked = True  # steps are cached per problem object
    jitted = getattr(step, "_fmg_init_jit", None)
    if jitted is None:
        jitted = step._fmg_init_jit = jax.jit(init)
    return jitted(problem.rhs)


def solve(
    problem: Problem,
    solver: str,
    omega: float,
    itr_max: int,
    eps: float = EPS_DEFAULT,
    precond: Optional[str] = None,
    history_path: Optional[str] = None,
    impl: str = "auto",
    check_every: Optional[int] = None,
) -> SolveResult:
    """``impl``: 'auto' (the red-black Triton kernel where solvers/dispatch.py
    picks it, XLA elsewhere), 'pallas' (the kernel, or ValueError where it
    cannot run), 'jnp' (XLA).  ``check_every``: convergence-check
    granularity (None = dispatch default; counts and histories do not
    depend on it)."""
    kind, _ = steps_mod.parse_name(solver)
    g = problem.grid
    # the one check of ``impl``: "pallas" raises here for every solver the
    # kernel does not run (the Krylov preconditioners included)
    use_kernel = dispatch.use_rb_kernel(
        kind, g.dtype, impl=impl, sharded=dispatch.is_sharded(problem.x0),
        standard_mask=problem.msk_is_standard(),
    )

    if kind == "pbicgstab":
        from .fused_cache import get_bicgstab

        run = get_bicgstab(problem, solver, omega, precond)
        result = run(problem.x0, problem.rhs, itr_max, eps, g.res_normal)
    elif kind == "cg":
        from .fused_cache import get_cg

        run = get_cg(problem, omega, precond)
        result = run(problem.x0, problem.rhs, itr_max, eps, g.res_normal)
    else:
        from .fused_cache import get_jnp_step, get_rb_step

        if use_kernel:
            step = get_rb_step(problem, solver, omega)
        else:
            step = get_jnp_step(problem, solver, omega)
        result = run_iterative(
            step, _initial_x(step, problem), problem.rhs, g.res_normal,
            itr_max, eps, check_every=check_every,
            # steps that run on their own state layout (the packed
            # red-black kernel, psor's skewed diagonal layout) carry
            # converters, folded into the loop's one executable
            pre=getattr(step, "_pre", None),
            post=getattr(step, "_post", None),
        )

    if history_path:
        result.write_history(history_path)
    return result
