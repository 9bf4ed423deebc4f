"""Batched distance + winner search — the framework's hot kernel (XLA path).

This replaces the reference's per-sample scalar scans (find_winner_euc,
lvq_pak.c:41-94; find_winner_knn :152-221) with the matmul form

    D[b, n] = ||x_b||^2 - 2 x_b . m_n + ||m_n||^2_masked(b)

computed as one batched matmul plus rank-1 corrections.  Masked
components (mask=1) are zeroed in x before the matmul and the matching
||m||^2 terms are removed with a second small matmul  mask_keep @ (M^2)^T
— exactly the reference's "skip masked components" semantics
(lvq_pak.c:63-72) at matmul speed (SURVEY.md §7 hard part 6).

A fused Triton kernel (argmin in the matmul epilogue, the distance block
never written to device memory) lives in ops.triton_winner; this module
is the portable XLA formulation and the reference oracle for it
(ops.dispatch chooses between them).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def sq_distances(
    x: jnp.ndarray,
    codes: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    precision="highest",
) -> jnp.ndarray:
    """(B, N) squared euclidean distances over unmasked components.

    x: (B, D) float32/bfloat16; codes: (N, D); mask: (B, D) nonzero where
    the component is masked off (excluded from the distance).

    precision defaults to 'highest' (true f32 matmul): the expanded form
    ||x||^2 - 2x.m + ||m||^2 cancels catastrophically for near-winners if
    the dot product is computed in reduced precision (bf16 or TF32).
    Pass None/'default' explicitly to trade accuracy for throughput.
    """
    if mask is not None:
        keep = 1.0 - mask.astype(x.dtype)
        xk = x * keep
    else:
        xk = x
    x2 = jnp.sum(xk * xk, axis=-1, keepdims=True)  # (B, 1)
    xc = jax.lax.dot_general(
        xk,
        codes,
        (((1,), (1,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32,
    )  # (B, N)
    if mask is not None:
        c2 = jax.lax.dot_general(
            keep,
            codes * codes,
            (((1,), (1,)), ((), ())),
            precision=precision,
            preferred_element_type=jnp.float32,
        )  # (B, N): sum over kept dims of m^2
    else:
        c2 = jnp.sum(codes * codes, axis=-1)[None, :]  # (1, N)
    return x2 - 2.0 * xc + c2


def find_winners(
    x: jnp.ndarray,
    codes: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    precision="highest",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched 1-NN: returns (indices (B,), sq-dists (B,)).

    Ties resolve to the first (lowest) index like the reference's strict
    `<` scan (lvq_pak.c:79)."""
    d = sq_distances(x, codes, mask, precision=precision)
    idx = jnp.argmin(d, axis=-1)
    return idx, jnp.take_along_axis(d, idx[:, None], axis=-1)[:, 0]


def topk_winners(
    x: jnp.ndarray,
    codes: jnp.ndarray,
    k: int,
    mask: Optional[jnp.ndarray] = None,
    reference_ties: bool = False,
    precision="highest",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched k-NN: returns (indices (B, k), sq-dists (B, k)) sorted by
    ascending distance.

    With reference_ties=True, equal distances order the later index first
    (the reference insertion rule, lvq_pak.c:197-211); otherwise ties take
    the lower index (cheaper on device).
    """
    d = sq_distances(x, codes, mask, precision=precision)
    n = d.shape[-1]
    if reference_ties:
        # sort key (distance asc, index desc): stable-sort the reversed
        # array so ties pick the highest original index first.
        order = jnp.argsort(d[..., ::-1], axis=-1, stable=True)[..., :k]
        idx = n - 1 - order
        return idx, jnp.take_along_axis(d, idx, axis=-1)
    negd, idx = jax.lax.top_k(-d, k)
    return idx, -negd


@partial(jax.jit, static_argnames=("k", "chunk", "reference_ties", "precision"))
def chunked_topk(
    x: jnp.ndarray,
    codes: jnp.ndarray,
    k: int,
    mask: Optional[jnp.ndarray] = None,
    chunk: int = 4096,
    reference_ties: bool = True,
    precision="highest",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """k-NN over a large query set without materializing the full (B, N)
    distance matrix: queries stream through in `chunk`-row tiles, each
    tile runs the dist-matmul + top-k on device (peak memory O(chunk*N)).

    This is the device-scale path for the self-kNN workloads the
    reference recomputes per pick (eveninit/elimin/knntest/setlabel,
    O(N^2 dim) scalar loops — eveninit.c:46-158, lvq_rout.c:38-80);
    results match topk_winners exactly, including the reference
    (distance asc, index desc) tie order."""
    B = x.shape[0]
    nchunks = -(-B // chunk)
    Bp = nchunks * chunk
    xp = jnp.zeros((Bp,) + x.shape[1:], dtype=x.dtype).at[:B].set(x)
    mp = None
    if mask is not None:
        mp = jnp.zeros((Bp,) + mask.shape[1:], dtype=mask.dtype).at[:B].set(mask)

    def one(args):
        xc, mc = args
        return topk_winners(xc, codes, k, mc, reference_ties=reference_ties,
                            precision=precision)

    xcs = xp.reshape(nchunks, chunk, -1)
    mcs = (mp.reshape(nchunks, chunk, -1) if mp is not None
           else jnp.zeros((nchunks, chunk, 0), dtype=jnp.uint8))
    idx, val = jax.lax.map(
        lambda a: one((a[0], a[1] if mask is not None else None)), (xcs, mcs)
    )
    return idx.reshape(Bp, k)[:B], val.reshape(Bp, k)[:B]


def pairwise_topk_mode(X, codes, knn, xmask=None, mode: str = "parity"):
    """Mode-dispatched kNN for the host tools (eveninit/setlabel/elimin/
    knntest): mode='parity' runs ops.exact.pairwise_topk UNCONDITIONALLY
    (C accumulation order at every size — byte-anchored output must not
    become scale-dependent), mode='fast' routes through the scale-aware
    auto_pairwise_topk below."""
    import numpy as np

    if mode == "fast":
        return auto_pairwise_topk(X, codes, knn, xmask)
    from . import exact

    return exact.pairwise_topk(np.asarray(X), np.asarray(codes), knn,
                               None if xmask is None else np.asarray(xmask))


def auto_pairwise_topk(X, codes, knn, xmask=None):
    """Scale-aware kNN front end for the mode='fast' host tools
    (eveninit/setlabel/elimin/knntest): the NumPy exact path
    (ops.exact.pairwise_topk, C accumulation order) below
    SOMVQ_AUTO_TOPK_PAIRS query*reference pairs and the
    device-chunked dist-matmul path above it.  The device path keeps the
    reference (distance asc, index desc) tie order and precision=
    "highest" exact-f32 matmuls (test_chunked_topk_matches_exact asserts
    index equality on real data); at scales with no goldens it makes the
    reference's O(N^2 dim) scalar workloads (eveninit.c:46-158,
    lvq_rout.c:38-80) feasible: a 1M-vector self-kNN is 1e12 pairs.

    The device path's f32 matmul accumulation order differs from the C
    scan's, so near-equal k-th neighbors can order differently in the
    last ulps above the threshold — there are no golden fixtures at
    such scales, but set SOMVQ_AUTO_TOPK_PAIRS=-1 (any negative) to
    force the exact host path at every size when C-identical output
    matters more than wall-clock.

    Inputs/outputs are NumPy ((N, knn) indices + squared distances)."""
    import os

    import numpy as np

    threshold = int(os.environ.get("SOMVQ_AUTO_TOPK_PAIRS", 1 << 25))
    n_pairs = X.shape[0] * codes.shape[0]
    if threshold < 0 or n_pairs <= threshold:
        from . import exact

        return exact.pairwise_topk(np.asarray(X), np.asarray(codes), knn,
                                   None if xmask is None else np.asarray(xmask))
    # keep the per-tile (chunk, N) distance block around 1 GB
    chunk = max(64, min(4096, (1 << 28) // max(1, codes.shape[0])))
    idx, val = chunked_topk(
        jnp.asarray(X), jnp.asarray(codes), knn,
        None if xmask is None else jnp.asarray(xmask), chunk=chunk,
    )
    return np.asarray(idx), np.asarray(val)
