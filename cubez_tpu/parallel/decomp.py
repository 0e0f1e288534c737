"""3D block-decomposition search — the CBrick findOptimalDivision equivalent
(CB_SubDomain_stub.h:255,434-491; driver use cz_Evaluate.cpp:103-159).

Enumerates all factorizations (dz, dx, dy) of the device count and scores
them the way CBrick documents (volume balance, then communication surface,
then cubeness).  Deterministic; ties broken by preferring more division along
J (the contiguous axis) last, then I.
"""

from __future__ import annotations

import math


def _divisions(nproc: int):
    out = []
    for dz in range(1, nproc + 1):
        if nproc % dz:
            continue
        rest = nproc // dz
        for dx in range(1, rest + 1):
            if rest % dx:
                continue
            dy = rest // dx
            out.append((dz, dx, dy))
    return out


def score_division(div, gsize):
    """Lower is better: (max block volume, halo surface per block, cubeness)."""
    (dz, dx, dy) = div
    nk, ni, nj = gsize
    bk, bi, bj = math.ceil(nk / dz), math.ceil(ni / dx), math.ceil(nj / dy)
    vol = bk * bi * bj
    surf = 0
    if dz > 1:
        surf += 2 * bi * bj
    if dx > 1:
        surf += 2 * bk * bj
    if dy > 1:
        surf += 2 * bk * bi
    ext = sorted((bk, bi, bj))
    cubeness = ext[2] / ext[0]
    return (vol, surf, cubeness)


def auto_division(nproc: int, gsize) -> tuple[int, int, int]:
    """Best (dz, dx, dy) for a (nk, ni, nj) global grid.

    Requires each axis divisible only at use time; the search itself allows
    uneven blocks like CBrick (enumerate(), CB_SubDomain_stub.h:434-491).
    Uses the native C++ search (native/czx_native.cpp) when built; the pure
    Python below is the reference implementation and fallback.
    """
    try:
        from ..utils import native

        nd = native.auto_division(nproc, gsize) if native.available() else None
        if nd is not None:
            return nd
    except ValueError:
        raise
    except Exception:
        pass
    cands = [
        d
        for d in _divisions(nproc)
        if d[0] <= gsize[0] and d[1] <= gsize[1] and d[2] <= gsize[2]
    ]
    if not cands:
        raise ValueError(f"cannot divide {gsize} over {nproc} devices")
    # prefer more division along the last (J) axis on ties
    return min(cands, key=lambda d: (score_division(d, gsize), -d[2], -d[1]))
