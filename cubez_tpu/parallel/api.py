"""Distributed solve API — the multi-chip counterpart of solvers.api.solve.

    from cubez_tpu.parallel import solve_dist, make_mesh
    cm = make_mesh(prob.grid.shape_kij)          # all local devices
    result = solve_dist(prob, cm, "sor2sma", omega=1.5, itr_max=10000)

The explicit shard_map jnp steps (parallel/dist.py: jacobi, sor2sma,
pcr_j_esa and pcr_rb, constant and MAF) run where they exist; every other
solver runs its serial jnp step on sharded arrays (auto-SPMD: XLA inserts
the halo collectives and all-reduces itself).  Both run the same
while_loop driver and convergence logic as the serial path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.problem import Problem
from ..solvers.driver import EPS_DEFAULT, SolveResult, run_iterative
from .dist import SYNCS, make_dist_step
from .mesh import CubeMesh


def solve_dist(
    problem: Problem,
    cmesh: CubeMesh,
    solver: str,
    omega: float,
    itr_max: int,
    eps: float = EPS_DEFAULT,
    history_path: Optional[str] = None,
    sync: str = "auto",
    check_every: Optional[int] = None,
    precond: Optional[str] = None,
) -> SolveResult:
    """Run a solver distributed over the mesh.

    The returned SolveResult.x is the assembled global (K, I, J) field.
    ``sync`` selects the red-black halo cadence of the explicit steps:
    'color' (one exchange per color, serial-equivalent; 'auto' is
    'color'), 'iter' (one exchange per iteration, the reference's
    multi-rank cadence, cz_Poisson.cpp:194-215) or 'overlap' (the
    per-color exchange overlapped with the interior update).  Every step
    here is a jnp step: there is no distributed kernel.
    """
    from ..solvers.steps import parse_name

    if sync not in ("auto",) + SYNCS:
        raise ValueError(f"sync must be 'auto' or one of {SYNCS}, got {sync!r}")
    g = problem.grid
    kind, _ = parse_name(solver)
    prob_sh = dataclasses.replace(
        problem,
        x0=cmesh.shard(problem.x0),
        rhs=cmesh.shard(problem.rhs),
        msk=cmesh.shard(problem.msk),
    )

    if kind in ("pbicgstab", "cg"):
        # Krylov vectors stay sharded fields (dots lower to psum
        # all-reduces under GSPMD)
        if kind == "cg":
            from ..solvers.cg import make_cg

            run = make_cg(prob_sh, omega, precond)
        else:
            from ..solvers.bicgstab import make_bicgstab

            run = make_bicgstab(prob_sh, solver, omega, precond)
        result = run(prob_sh.x0, prob_sh.rhs, itr_max, eps, g.res_normal)
    else:
        try:
            step = make_dist_step(
                problem, cmesh, solver, omega,
                sync="color" if sync == "auto" else sync,
            )
        except NotImplementedError:
            if sync not in ("auto", "color"):
                raise
            step = None
        if step is not None:
            result = run_iterative(
                step, prob_sh.x0, prob_sh.rhs, g.res_normal, itr_max, eps,
                check_every=check_every,
            )
        else:
            # auto-SPMD: the serial steps are pure jnp, so jit on sharded
            # arrays lets XLA insert the collectives (GSPMD) — serial-exact
            # semantics on any mesh
            from ..solvers.api import _initial_x
            from ..solvers.steps import make_step

            sstep = make_step(prob_sh, solver, omega)
            result = run_iterative(
                sstep, _initial_x(sstep, prob_sh), prob_sh.rhs,
                g.res_normal, itr_max, eps, check_every=check_every,
                pre=getattr(sstep, "_pre", None),
                post=getattr(sstep, "_post", None),
            )

    if history_path:
        result.write_history(history_path)
    return result
