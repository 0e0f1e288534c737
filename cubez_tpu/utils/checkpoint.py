"""Checkpoint / restart for long solves.

The reference has no restart path — only a final SPH dump (fileout_t,
cz_utility.f90:17-47; SURVEY.md §5).  Production solves at scale need one,
so this is a deliberate capability extension: portable .npz checkpoints of
the solver state plus enough metadata to validate compatibility on load.

Works with any array layout (plain, K-padded, line-layout) — the state is
captured as the canonical (K, I, J) field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

FORMAT_VERSION = 1


def save(path, x, *, solver: str, iters: int, res: float, omega: float,
         eps: float, history=None) -> None:
    """Write a restart checkpoint of the (K, I, J) solution field."""
    np.savez_compressed(
        str(path),
        version=FORMAT_VERSION,
        x=np.asarray(x),
        solver=str(solver),
        iters=int(iters),
        res=float(res),
        omega=float(omega),
        eps=float(eps),
        history=np.asarray(history if history is not None else []),
    )


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    x: np.ndarray
    solver: str
    iters: int
    res: float
    omega: float
    eps: float
    history: np.ndarray


def load(path) -> Checkpoint:
    with np.load(str(path), allow_pickle=False) as z:
        ver = int(z["version"])
        if ver != FORMAT_VERSION:
            raise ValueError(f"checkpoint version {ver} != {FORMAT_VERSION}")
        return Checkpoint(
            x=z["x"],
            solver=str(z["solver"]),
            iters=int(z["iters"]),
            res=float(z["res"]),
            omega=float(z["omega"]),
            eps=float(z["eps"]),
            history=z["history"],
        )


def _continue(problem, ckpt: Checkpoint, itr_max, solver, omega, eps):
    """Shared continuation plumbing: shape check, x0 replace, and
    ckpt-field defaulting — one copy for resume and resume_dist."""
    import dataclasses as dc

    if ckpt.x.shape != problem.grid.shape_kij:
        raise ValueError(
            f"checkpoint shape {ckpt.x.shape} != problem "
            f"{problem.grid.shape_kij}"
        )
    prob = dc.replace(problem, x0=jnp.asarray(ckpt.x, problem.grid.dtype))
    return prob, dict(
        omega=omega if omega is not None else ckpt.omega,
        itr_max=itr_max,
        eps=eps if eps is not None else ckpt.eps,
    ), solver or ckpt.solver


def resume(problem, ckpt: Checkpoint, itr_max: int, *, solver: Optional[str] = None,
           omega: Optional[float] = None, eps: Optional[float] = None, **kw):
    """Continue a checkpointed solve for up to ``itr_max`` more iterations.

    Returns the SolveResult of the continuation; the caller stitches
    histories if needed.
    """
    from ..solvers.api import solve

    prob, args, name = _continue(problem, ckpt, itr_max, solver, omega, eps)
    return solve(prob, name, **args, **kw)


def resume_dist(problem, cmesh, ckpt: Checkpoint, itr_max: int, *,
                solver: Optional[str] = None, omega: Optional[float] = None,
                eps: Optional[float] = None, **kw):
    """Distributed continuation of a checkpointed solve over ``cmesh``.

    The checkpoint stores the canonical global (K, I, J) field, so a
    solve may be checkpointed on one mesh (or serially) and resumed on
    any other — solve_dist re-shards the state over the mesh."""
    from ..parallel.api import solve_dist

    prob, args, name = _continue(problem, ckpt, itr_max, solver, omega, eps)
    return solve_dist(prob, cmesh, name, **args, **kw)
