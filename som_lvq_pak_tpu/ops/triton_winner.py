"""Pallas-Triton winner search for the GPU hot path.

The plain XLA form (ops.distance.find_winners) writes and re-reads a
(B, N) float32 distance matrix: 1 GiB at B=4096, N=65,536.  This kernel
keeps the distances in registers:

* The grid runs over batch tiles and, when the batch alone gives too few
  blocks to fill the card, over a few contiguous codebook splits.
* Each block loops over codebook tiles, computes  ||m||^2 - 2 x.m  for
  the tile (||m||^2 from the tile in registers) and folds it into its
  running top-1 or top-2 with strict <, so the lowest index wins ties
  (the C scan, lvq_pak.c:79).
* The splits' candidates are merged in XLA (a (S, B) array), and the
  winners' distances are recomputed exactly in float32.

The product runs as 3xTF32 (`lax.DotAlgorithmPreset.TF32_TF32_F32_X3`):
three TF32 tensor-core products per tile, about float32 accuracy.  Plain
TF32 keeps ~3 decimal digits and can flip near-tie winners of the
expanded distance form.

Shapes are padded here to the blocks' powers of two; padded codebook rows
never win (masked to +inf by index).  `interpret=True` runs the kernel in
the Pallas interpreter (CPU tests); the choice between this kernel and
XLA is ops.dispatch's.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_DOT = lax.DotAlgorithmPreset.TF32_TF32_F32_X3

# a split of the codebook is added until the grid has this many blocks:
# twice the 132 SMs of an H100, rounded to a power of two
_MIN_BLOCKS = 256

# widest feature dimension the kernel keeps in registers (ops.dispatch
# sends wider data to XLA)
MAX_DIM = 256


def _pow2(n: int, lo: int = 1) -> int:
    return max(lo, 1 << max(0, (int(n) - 1).bit_length()))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad2(a, rows: int, cols: int):
    r, c = a.shape
    if (r, c) == (rows, cols):
        return a
    return jnp.pad(a, ((0, rows - r), (0, cols - c)))


def _dot_t(a, b, interpret):
    """a @ b.T; the interpreter runs it with XLA's CPU dot, which takes
    no TF32 algorithm, so it computes in float32 there."""
    prec = lax.Precision.HIGHEST if interpret else _DOT
    return pl.dot(a, b, trans_b=True, precision=prec)


def _winner_kernel(x_ref, m_ref, *out_refs, k, n_codes, block_n, split_tiles,
                   interpret):
    s = pl.program_id(1)
    x = x_ref[...]                                       # (bb, Dp)
    bb = x.shape[0]
    lcol = lax.broadcasted_iota(jnp.int32, (bb, block_n), 1)

    def body(t, carry):
        start = (s * split_tiles + t) * block_n           # global row index
        m = m_ref[pl.ds(t * block_n, block_n), :]         # (bn, Dp)
        m2 = jnp.sum(m * m, axis=1)
        d = m2[None, :] - 2.0 * _dot_t(x, m, interpret)
        d = jnp.where(start + lcol < n_codes, d, jnp.inf)
        a1 = jnp.argmin(d, axis=1).astype(jnp.int32)
        b1 = jnp.min(d, axis=1)
        if k == 1:
            v1, i1 = carry
            better = b1 < v1
            return (jnp.where(better, b1, v1),
                    jnp.where(better, a1 + start, i1))
        v1, i1, v2, i2 = carry
        d2 = jnp.where(lcol == a1[:, None], jnp.inf, d)
        a2 = jnp.argmin(d2, axis=1).astype(jnp.int32)
        b2 = jnp.min(d2, axis=1)
        g1, g2 = a1 + start, a2 + start
        # both pairs are sorted; strict < keeps the earlier tile on ties
        new_best = b1 < v1
        sec_if_new = b2 < v1
        sec_if_old = b1 < v2
        nv2 = jnp.where(new_best, jnp.where(sec_if_new, b2, v1),
                        jnp.where(sec_if_old, b1, v2))
        ni2 = jnp.where(new_best, jnp.where(sec_if_new, g2, i1),
                        jnp.where(sec_if_old, g1, i2))
        return (jnp.where(new_best, b1, v1), jnp.where(new_best, g1, i1),
                nv2, ni2)

    inf = jnp.full((bb,), jnp.inf, jnp.float32)
    zero = jnp.zeros((bb,), jnp.int32)
    init = (inf, zero) if k == 1 else (inf, zero, inf, zero)
    out = lax.fori_loop(0, split_tiles, body, init)
    for ref, val in zip(out_refs, out):
        ref[...] = val


@functools.partial(jax.jit, static_argnames=("k", "block_b", "block_n",
                                             "num_warps", "num_stages",
                                             "interpret"))
def winner_topk(x, codes, k: int = 1, block_b: int = 128, block_n: int = 64,
                num_warps: int = 8, num_stages: int = 2,
                interpret: bool = False):
    """k nearest codebook rows (k in {1, 2}) of each row of x.

    Returns (idx (B, k) int32, sqdist (B, k) float32), ascending; the
    distances are recomputed exactly in float32 from the chosen rows.
    Ties take the lowest index."""
    if k not in (1, 2):
        raise ValueError(f"winner_topk: k={k} (1 or 2)")
    B, D = x.shape
    N = codes.shape[0]
    if N < k:
        raise ValueError(f"winner_topk: {N} codebook rows < k={k}")
    Dp = _pow2(D, 16)
    bb = min(block_b, _pow2(B, 16))
    bn = min(block_n, _pow2(N, 16))
    nb = _cdiv(B, bb)
    n_tiles = _cdiv(N, bn)
    splits = min(_pow2(_cdiv(_MIN_BLOCKS, nb)), _pow2(n_tiles))
    split_tiles = _cdiv(n_tiles, splits)
    splits = _cdiv(n_tiles, split_tiles)
    Np = splits * split_tiles * bn
    xp = _pad2(x.astype(jnp.float32), nb * bb, Dp)
    mp = _pad2(codes.astype(jnp.float32), Np, Dp)

    kernel = functools.partial(_winner_kernel, k=k, n_codes=N, block_n=bn,
                               split_tiles=split_tiles, interpret=interpret)
    out_spec = pl.BlockSpec((None, bb), lambda i, s: (s, i))
    n_out = 2 * k
    out = pl.pallas_call(
        kernel,
        grid=(nb, splits),
        in_specs=[pl.BlockSpec((bb, Dp), lambda i, s: (i, 0)),
                  pl.BlockSpec((split_tiles * bn, Dp), lambda i, s: (s, 0))],
        out_specs=[out_spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((splits, nb * bb),
                                        jnp.float32 if j % 2 == 0 else jnp.int32)
                   for j in range(n_out)],
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=num_stages),
        backend="triton",
        interpret=interpret,
        name=f"somvq_winner_top{k}",
    )(xp, mp)
    # merge the splits' candidates: order (split, rank) is ascending
    # global index among equal values, so argmin's first hit is the
    # lowest index
    vals = jnp.stack(out[0::2], axis=-1)[:, :B]          # (S, B, k)
    idxs = jnp.stack(out[1::2], axis=-1)[:, :B]
    vals = jnp.moveaxis(vals, 0, 1).reshape(B, splits * k)
    idxs = jnp.moveaxis(idxs, 0, 1).reshape(B, splits * k)
    picks = []
    for _ in range(k):
        p = jnp.argmin(vals, axis=1)
        picks.append(jnp.take_along_axis(idxs, p[:, None], axis=1)[:, 0])
        vals = jnp.where(jnp.arange(vals.shape[1])[None, :] == p[:, None],
                         jnp.inf, vals)
    idx = jnp.stack(picks, axis=1)
    diff = x.astype(jnp.float32)[:, None, :] - codes.astype(jnp.float32)[idx]
    return idx, jnp.sum(diff * diff, axis=-1)
