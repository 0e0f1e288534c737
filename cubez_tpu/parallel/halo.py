"""Width-1 halo exchange over the ('z','x','y') mesh via lax.ppermute.

The JAX replacement for CBrick's 6-face nonblocking Isend/Irecv halo
sync (BrickComm::Comm_S_node wrapped by CZ::Comm_S, cz_comm.cpp:23-38).
``ppermute`` fills zeros for edge devices with no neighbor, which doubles as
the physical-boundary zero padding our masked sweeps expect.

Exchanges are done axis-by-axis on the progressively padded block, so edge
ghosts are consistent two-hop values (the reference never reads diagonal
ghosts either — NOFACE=6, CB_Define_stub.h:31-35).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .mesh import AXES


def _pad_axis(x, array_axis: int, mesh_axis: str):
    """Pad one array axis with width-1 ghosts from the mesh neighbors."""
    n = lax.axis_size(mesh_axis)
    idx = [slice(None)] * x.ndim

    idx[array_axis] = slice(0, 1)
    lo_face = x[tuple(idx)]
    idx[array_axis] = slice(x.shape[array_axis] - 1, x.shape[array_axis])
    hi_face = x[tuple(idx)]

    if n == 1:
        ghost_lo = jnp.zeros_like(lo_face)
        ghost_hi = jnp.zeros_like(hi_face)
    else:
        # receive (i+1)'s low face into my high ghost, and vice versa
        ghost_hi = lax.ppermute(
            lo_face, mesh_axis, [(i, i - 1) for i in range(1, n)]
        )
        ghost_lo = lax.ppermute(
            hi_face, mesh_axis, [(i, i + 1) for i in range(n - 1)]
        )
    return jnp.concatenate([ghost_lo, x, ghost_hi], axis=array_axis)


def exchange_halo(x):
    """Local block (lk, li, lj) -> padded (lk+2, li+2, lj+2) with neighbor
    ghosts (zeros at physical boundaries).  Must run inside shard_map over
    the ('z','x','y') mesh."""
    for array_axis, mesh_axis in enumerate(AXES):
        x = _pad_axis(x, array_axis, mesh_axis)
    return x


def pad_zeros(x):
    """Zero-pad a local block by 1 on every side (for b/msk companions)."""
    return jnp.pad(x, ((1, 1),) * x.ndim)


def psum_all(v):
    return lax.psum(v, AXES)


def global_offsets(block_shape):
    """(k0, i0, j0) global start indices of this device's block (traced)."""
    lk, li, lj = block_shape
    return (
        lax.axis_index("z") * lk,
        lax.axis_index("x") * li,
        lax.axis_index("y") * lj,
    )
