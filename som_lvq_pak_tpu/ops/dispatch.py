"""The winner op and the SOM update op of every fast path.

The minibatch SOM/LVQ steps, the sharded steps, fast qerror and fast
accuracy call these functions and nothing below them.

* Winner search: on the GPU, unmasked data with D <= triton_winner.MAX_DIM
  runs the Pallas-Triton kernel (ops.triton_winner), which never writes
  the (B, N) distance block to device memory.  Everywhere else (the CPU,
  masked data, very wide D) runs ops.distance's XLA form at
  precision="highest", which is also the kernel's reference.
* Update: the XLA form below on every backend.  It builds W (B, N) from
  the BMU indices; XLA runs its contraction at the backend's default f32
  precision (TF32 on an H100).  A Triton update kernel that built W in
  registers measured slower than this on the H100 and was removed
  (PERF.md).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from . import triton_winner
from .distance import find_winners, topk_winners

# the XLA winner search materialises a (rows, N) f32 distance block; past
# this many elements it runs over row chunks (1 GiB per chunk)
_XLA_BLOCK_ELEMS = 1 << 28


def winner_impl(dim: int, masked: bool, backend: Optional[str] = None) -> str:
    """'triton' or 'xla': the winner search used for this backend/shape."""
    backend = backend or jax.default_backend()
    if backend == "gpu" and not masked and dim <= triton_winner.MAX_DIM:
        return "triton"
    return "xla"


def _xla_bmu(x, codes, mask):
    B, N = x.shape[0], codes.shape[0]
    rows = max(1, _XLA_BLOCK_ELEMS // max(1, N))
    if B <= rows:
        return find_winners(x, codes, mask)
    nchunks = -(-B // rows)
    pad = nchunks * rows - B
    xs = jnp.pad(x, ((0, pad), (0, 0))).reshape(nchunks, rows, -1)
    if mask is None:
        idx, d = lax.map(lambda c: find_winners(c, codes), xs)
    else:
        ms = jnp.pad(mask, ((0, pad), (0, 0))).reshape(nchunks, rows, -1)
        idx, d = lax.map(lambda a: find_winners(a[0], codes, a[1]), (xs, ms))
    return idx.reshape(-1)[:B], d.reshape(-1)[:B]


def find_bmu(x, codes, mask: Optional[jnp.ndarray] = None):
    """Batched 1-NN: (idx (B,) int32, sqdist (B,) f32); ties take the
    lowest index (lvq_pak.c:79).  `mask` (B, D) nonzero = component
    excluded from the distance (lvq_pak.c:63-72)."""
    if winner_impl(x.shape[1], mask is not None) == "triton":
        idx, d = triton_winner.winner_topk(x, codes, k=1)
        return idx[:, 0], d[:, 0]
    idx, d = _xla_bmu(x, codes, mask)
    return idx.astype(jnp.int32), d


def find_top2(x, codes, mask: Optional[jnp.ndarray] = None):
    """Batched 2-NN: (idx (B, 2) int32, sqdist (B, 2) f32), ascending;
    ties take the lower index."""
    if winner_impl(x.shape[1], mask is not None) == "triton":
        return triton_winner.winner_topk(x, codes, k=2)
    idx, d = topk_winners(x, codes, 2, mask)
    return idx.astype(jnp.int32), d


def grid_sq_dists_idx(bmu, n_rows: int, xdim: int, hexa: bool,
                      unit_offset=0):
    """(B, n_rows) squared grid distances from each BMU to units
    unit_offset .. unit_offset + n_rows - 1, from flat indices: dx from
    columns and 0.5-offsets, hexa dy^2 = rowdiff^2 * 0.75.  Every term is
    exactly representable in f32, so the bubble radius test is exact
    math: the scaled (row * sqrt(0.75)) form rounds, and whether a
    compiler factors it decides inclusion at exact-boundary distances
    (som_rout.c:434-468)."""
    u = unit_offset + jnp.arange(n_rows, dtype=jnp.int32)
    ucol = (u % xdim).astype(jnp.float32)[None, :]
    urow = (u // xdim)[None, :]
    bcol = (bmu % xdim).astype(jnp.float32)[:, None]
    brow = (bmu // xdim)[:, None]
    rd = (urow - brow).astype(jnp.float32)
    if hexa:
        dx = (ucol + 0.5 * (urow % 2).astype(jnp.float32)
              - bcol - 0.5 * (brow % 2).astype(jnp.float32))
        return dx * dx + (rd * rd) * 0.75
    dx = ucol - bcol
    return dx * dx + rd * rd


def guarded_blend(codes, wx, wsum):
    """codes + (wx - wsum*codes), saturated for stability.

    The raw accumulated-online update is exact only while a unit's total
    neighbourhood weight wsum <= 1; beyond that (large B x alpha x wide
    gaussian) the multiplier (1 - wsum) goes negative and training
    diverges.  Saturate at the batch weighted mean: identical result for
    wsum <= 1, a full blend to wx/wsum otherwise — the sequential
    reference can never overshoot past its samples (som_rout.c:472-549
    applies alpha <= 1 per sample), and neither does this."""
    safe = jnp.maximum(wsum, 1e-30)
    blend = jnp.minimum(wsum, 1.0)
    return codes + blend * (wx / safe - codes)


def som_accumulate(xb, bmu, alpha, radius, *, n_rows: int, xdim: int,
                   hexa: bool, gaussian: bool, unit_offset=0,
                   mask: Optional[jnp.ndarray] = None):
    """Neighbourhood accumulators for codebook rows unit_offset ..
    unit_offset + n_rows - 1: (W^T X (n_rows, D), W^T 1 (n_rows, 1), or
    (n_rows, D) per component when masked).  W[b, u] = alpha_b *
    h(grid distance bmu_b -> u), h bubble (som_rout.c:472-506) or
    gaussian (:511-549); `alpha` is a scalar or per-sample (B,)."""
    d2 = grid_sq_dists_idx(bmu, n_rows, xdim, hexa, unit_offset)
    a = jnp.broadcast_to(jnp.asarray(alpha, jnp.float32), xb.shape[:1])[:, None]
    if gaussian:
        W = a * jnp.exp(-d2 / (2.0 * radius * radius))
    else:
        W = jnp.where(d2 <= radius * radius, a, 0.0)
    dims = (((0,), (0,)), ((), ()))
    if mask is None:
        wx = lax.dot_general(W, xb, dims, preferred_element_type=jnp.float32)
        return wx, jnp.sum(W, axis=0)[:, None]
    keep = 1.0 - mask.astype(jnp.float32)
    wx = lax.dot_general(W, xb * keep, dims, preferred_element_type=jnp.float32)
    # per-(unit, comp) weight mass: masked comps contribute nothing
    wsum = lax.dot_general(W, keep, dims, preferred_element_type=jnp.float32)
    return wx, wsum


def som_update(codes, xb, bmu, alpha, radius, *, xdim: int, hexa: bool,
               gaussian: bool, mask: Optional[jnp.ndarray] = None):
    """One batch neighbourhood update of the whole codebook:
    guarded_blend(codes, W^T X, W^T 1)."""
    wx, wsum = som_accumulate(xb, bmu, alpha, radius, n_rows=codes.shape[0],
                              xdim=xdim, hexa=hexa, gaussian=gaussian,
                              mask=mask)
    return guarded_blend(codes, wx, wsum)
