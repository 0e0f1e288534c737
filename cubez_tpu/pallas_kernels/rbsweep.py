"""Red-black SOR sweep as a Pallas kernel for the GPU (Triton route).

The XLA form of one red-black iteration (ops/stencil.py::sor2sma_sweep)
is two masked full-field passes: each reads x and b, writes x and reduces
dp^2, and computes an update for every node only to throw half of them
away under the color mask.  This kernel stores the two colors densely and
updates one color per launch, so an iteration moves each color's half of
x about three times (read the other color, read and write its own) and
reads b only when it is nonzero.

Layout ("packed red-black")
---------------------------
Color c holds the nodes with (i + j + k + offset + 1) % 2 == c (the
psor2sma_core checkerboard, cz_solver.f90:451-466).  For each (k, j)
exactly one row of the i-pair {2*i2, 2*i2 + 1} has color c, so

    P[c, k, i2, j] = x[k, 2*i2 + s_c(k, j), j],
    s_c(k, j) = (k + j + offset + 1 + c) % 2

and the packed state is one (2, K, ceil(I/2), J) array.  An odd I gets one
padding row, which is never an inner node.  In this layout the neighbours
of a color-c node are all in the other color's array:

  * k +- 1 and j +- 1: the parity flips with k (or j) and with the color,
    so they sit at the same (i2, j) (or (k, i2)) of the other color;
  * i - 1 and i + 1: the other color's row i2 and one of rows i2 - 1 and
    i2 + 1, picked by s_c.

Per node the arithmetic follows ops/stencil.py::jacobi_delta (the six
neighbours summed in nbr6's order, then ``((ss - b) / 6 - x) * omega``);
the MAF form follows ops/maf.py::maf_delta with the separable metric
tables passed as 1-D inputs indexed by the physical i, j and k.  Each
program reduces its own dp^2 into one entry of a small partial-sum array
that XLA adds up afterwards: no atomics, so r2 is deterministic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# tile of one program: (rows of i2, lanes of j), powers of two (Triton).
# Chosen by measurement on an H100 80GB HBM3 at 700 W, 512^3 f32, 200
# fixed sweeps: (16, 128) with 8 warps 892 us/iter; (4, 256)/8 907;
# (1, 512)/4 933; (8, 64)/4 964; (8, 128)/4 970; (2, 256)/4 980;
# (4, 128)/4 982 (PERF.md, "Hand-written kernels against XLA").
BLOCK = (16, 128)
NUM_WARPS = 8


def _color_rows(K, J, offset):
    """(K, 1, J) bool: True where color 0 sits on the even row of its
    i-pair (s_0 == 0)."""
    k = jnp.arange(K, dtype=jnp.int32)[:, None, None]
    j = jnp.arange(J, dtype=jnp.int32)[None, None, :]
    return (k + j + offset + 1) % 2 == 0


def pack_rb(a, offset: int = 0):
    """(K, I, J) field -> packed (2, K, ceil(I/2), J) red/black pair.

    Apply to x and b alike (same permutation)."""
    K, I, J = a.shape
    if I % 2:
        a = jnp.pad(a, ((0, 0), (0, 1), (0, 0)))
    xe, xo = a[:, 0::2, :], a[:, 1::2, :]
    red_even = _color_rows(K, J, offset)
    return jnp.stack(
        [jnp.where(red_even, xe, xo), jnp.where(red_even, xo, xe)]
    )


def unpack_rb(p, shape, offset: int = 0):
    """Inverse of :func:`pack_rb`."""
    K, I, J = shape
    red_even = _color_rows(K, J, offset)
    xe = jnp.where(red_even, p[0], p[1])
    xo = jnp.where(red_even, p[1], p[0])
    I2 = p.shape[2]
    return jnp.stack([xe, xo], axis=2).reshape(K, 2 * I2, J)[:, :I, :]


def maf_tables(mc, shape, dtype):
    """The separable MAF weights as nine 1-D tables, computed with the same
    expressions as ops/maf.py::MafCoeffs (so they round alike):
    (wxp, wxm, c1) over the padded physical i, (wyp, wym, c2) over j,
    (wzp, wzm, c3) over k."""
    K, I, J = shape
    Ip = I + I % 2

    def vec(v, n, npad):
        v = jnp.asarray(v, dtype).reshape(-1)[:n]
        return jnp.pad(v, (0, npad - n), constant_values=1)

    c1, c7 = vec(mc.c1, I, Ip), vec(mc.c7, I, Ip)
    c2, c8 = vec(mc.c2, J, J), vec(mc.c8, J, J)
    c3, c9 = vec(mc.c3, K, K), vec(mc.c9, K, K)
    return (
        c1 + 0.5 * c7, c1 - 0.5 * c7, c1,
        c2 + 0.5 * c8, c2 - 0.5 * c8, c2,
        c3 + 0.5 * c9, c3 - 0.5 * c9, c3,
    )


def _color_kernel(*refs, color, shape, offset, omega, has_b, maf, block):
    K, I, J = shape
    refs = list(refs)
    p_ref = refs.pop(0)
    b_ref = refs.pop(0) if has_b else None
    tabs = [refs.pop(0) for _ in range(9)] if maf else None
    out_ref, r2_ref = refs
    bi, bj = block
    k = pl.program_id(0)
    ti = pl.program_id(1)
    tj = pl.program_id(2)
    i2 = ti * bi + jax.lax.broadcasted_iota(jnp.int32, (bi, bj), 0)
    j = tj * bj + jax.lax.broadcasted_iota(jnp.int32, (bi, bj), 1)
    two = jnp.asarray(2, jnp.int32)
    s = jax.lax.rem(k + j + (offset + 1 + color), two)
    i = 2 * i2 + s
    inner = (
        (k >= 1) & (k <= K - 2) & (j >= 1) & (j <= J - 2)
        & (i >= 1) & (i <= I - 2)
    )
    up = s == 1  # the pair's other i-neighbour is row i2 + 1 (else i2 - 1)
    o = 1 - color

    def load(ref, *idx, mask=inner):
        return plgpu.load(ref.at[idx], mask=mask, other=0.0)

    xc = load(p_ref, color, k, i2, j)
    oc = load(p_ref, o, k, i2, j)
    xm = jnp.where(up, oc, load(p_ref, o, k, i2 - 1, j, mask=inner & ~up))
    xp = jnp.where(up, load(p_ref, o, k, i2 + 1, j, mask=inner & up), oc)
    ym = load(p_ref, o, k, i2, j - 1)
    yp = load(p_ref, o, k, i2, j + 1)
    zm = load(p_ref, o, k - 1, i2, j)
    zp = load(p_ref, o, k + 1, i2, j)
    dt = xc.dtype
    if maf:
        wxp, wxm, c1, wyp, wym, c2 = (
            load(t, idx) for t, idx in zip(tabs, (i, i, i, j, j, j))
        )
        wzp, wzm, c3 = (t[k] for t in tabs[6:])  # k < K always
        rp = wxp * xp + wxm * xm + wyp * yp + wym * ym + wzp * zp + wzm * zm
        if has_b:
            rp = rp + load(b_ref, color, k, i2, j)
        dd = jnp.asarray(2.0, dt) * (c1 + c2 + c3)
        dp = (rp / dd - xc) * jnp.asarray(omega, dt)
    else:
        ss = xm + xp + ym + yp + zm + zp
        if has_b:
            ss = ss - load(b_ref, color, k, i2, j)
        dp = (ss / jnp.asarray(6.0, dt) - xc) * jnp.asarray(omega, dt)
    dp = jnp.where(inner, dp, jnp.zeros((), dt))
    plgpu.store(out_ref.at[color, k, i2, j], xc + dp, mask=inner)
    d32 = dp.astype(jnp.float32)
    r2_ref[k, ti, tj] = jnp.sum(d32 * d32)


def make_rb_step(
    shape,
    dtype=jnp.float32,
    *,
    omega: float,
    offset: int = 0,
    mc=None,
    b_is_zero: bool = False,
    interpret: bool = False,
):
    """Build ``step(p, bp) -> (p_new, r2)`` over packed (pack_rb) arrays:
    one red-black iteration, red then black, as two launches.

    ``mc`` (a MafCoeffs) switches to the variable-coefficient update.
    ``b_is_zero`` skips the right-hand side (the step still takes ``bp``
    and ignores it).  ``step.pad`` / ``step.unpad`` convert (K, I, J)
    fields to and from the packed layout.  ``interpret`` runs the kernel
    in the Pallas interpreter (tests on the CPU)."""
    K, I, J = shape
    I2 = (I + 1) // 2
    # small grids shrink the tile to the array (each program masks its edges)
    bi = min(BLOCK[0], pl.next_power_of_2(I2))
    bj = min(BLOCK[1], pl.next_power_of_2(J))
    grid = (K, pl.cdiv(I2, bi), pl.cdiv(J, bj))
    maf = mc is not None
    has_b = not b_is_zero
    tables = maf_tables(mc, shape, dtype) if maf else ()

    def call(color):
        return pl.pallas_call(
            functools.partial(
                _color_kernel, color=color, shape=(K, I, J),
                offset=int(offset), omega=float(omega), has_b=has_b,
                maf=maf, block=(bi, bj),
            ),
            grid=grid,
            out_shape=(
                jax.ShapeDtypeStruct((2, K, I2, J), dtype),
                jax.ShapeDtypeStruct(grid, jnp.float32),
            ),
            input_output_aliases={0: 0},
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
            interpret=interpret,
            name=f"rb_sweep_{'black' if color else 'red'}",
        )

    red, black = call(0), call(1)

    def step(p, bp):
        extra = ((bp,) if has_b else ()) + tables
        p, r2a = red(p, *extra)
        p, r2b = black(p, *extra)
        return p, (jnp.sum(r2a) + jnp.sum(r2b)).astype(dtype)

    step.pad = functools.partial(pack_rb, offset=offset)
    step.unpad = functools.partial(unpack_rb, shape=(K, I, J), offset=offset)
    return step
