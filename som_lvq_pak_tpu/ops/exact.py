"""Host-side primitives with the reference's exact C `float` semantics.

These back the *parity* training/eval mode, which reproduces the C
package bit-for-bit at equal seeds and schedules (the acceptance targets
in BASELINE.md).  The production device path lives in ops.dispatch /
ops.distance / ops.triton_winner; parity mode exists to prove numerical fidelity and
to anchor the golden tests, exactly as SURVEY.md §7 prescribes ("parity
mode runs B=1", "reproduce LCG exactly on host").

Float discipline: the C package accumulates distances in 32-bit float in
index order (find_winner_euc, lvq_pak.c:41-94), adapts with
`c += α(x−c)` in float (lvq_pak.c:339-351), and takes sqrt in double.
NumPy float32 ops are IEEE-754 single ops, so doing the same op sequence
here gives bit-identical results (no FMA contraction, no reassociation —
both verified against the compiled reference).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

F32 = np.float32


def seq_sq_distances(
    x: np.ndarray, codes: np.ndarray, xmask: Optional[np.ndarray] = None
) -> np.ndarray:
    """(noc,) float32 squared distances of sample x to every code,
    accumulated dimension-by-dimension like the C scan (lvq_pak.c:62-73).
    Masked components of x are skipped entirely."""
    dim = codes.shape[1]
    acc = np.zeros(codes.shape[0], dtype=F32)
    for i in range(dim):
        if xmask is not None and xmask[i]:
            continue
        diff = codes[:, i] - x[i]  # float32
        acc = acc + diff * diff  # float32, per-dim sequential
    return acc


def pairwise_sq_distances(
    X: np.ndarray, codes: np.ndarray, xmask: Optional[np.ndarray] = None
) -> np.ndarray:
    """(N, noc) float32 squared distances with C accumulation order
    (sequential over dims).  Vectorized over the (N, noc) pair grid."""
    N, dim = X.shape
    acc = np.zeros((N, codes.shape[0]), dtype=F32)
    for i in range(dim):
        diff = codes[None, :, i] - X[:, None, i]
        d2 = diff * diff
        if xmask is not None:
            d2 = np.where(xmask[:, None, i] != 0, F32(0.0), d2)
        acc = acc + d2
    return acc


def find_winner_euc(
    x: np.ndarray, codes: np.ndarray, xmask: Optional[np.ndarray] = None
) -> Tuple[int, np.float32]:
    """1-NN with the C tie rule: strict `<` scan → first index wins
    (lvq_pak.c:79).  Returns (-1, -1.0) for an all-masked sample."""
    if xmask is not None and xmask.all():
        return -1, F32(-1.0)
    d = seq_sq_distances(x, codes, xmask)
    idx = int(np.argmin(d))  # np.argmin returns the first minimum
    return idx, d[idx]


def find_winner_knn(
    x: np.ndarray, codes: np.ndarray, knn: int, xmask: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """k-NN with the C insertion-sort tie rule: equal distances place the
    *later-scanned* code first (lvq_pak.c:197-211 inserts a new entry
    before existing entries of equal distance).  Returns (indices, dists)
    sorted by (distance asc, index desc)."""
    if knn == 1:
        i, d = find_winner_euc(x, codes, xmask)
        return np.array([i]), np.array([d], dtype=F32)
    d = seq_sq_distances(x, codes, xmask)
    n = d.shape[0]
    order = np.lexsort((-np.arange(n), d))[:knn]
    return order, d[order]


def pairwise_topk(
    X: np.ndarray, codes: np.ndarray, knn: int, xmask: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched find_winner_knn: (N, knn) indices and distances with the
    same (distance asc, index desc) ordering."""
    d = pairwise_sq_distances(X, codes, xmask)
    n = d.shape[1]
    # lexsort over rows: primary dist asc, secondary index desc
    idx = np.lexsort((np.broadcast_to(-np.arange(n), d.shape), d), axis=1)[:, :knn]
    return idx, np.take_along_axis(d, idx, axis=1)


def adapt_vector(
    code: np.ndarray, x: np.ndarray, alpha: np.float32, xmask: Optional[np.ndarray] = None
) -> np.ndarray:
    """c += α(x−c) skipping masked components (lvq_pak.c:339-351).
    Returns the updated code (float32)."""
    upd = code + F32(alpha) * (x - code)
    if xmask is not None:
        upd = np.where(xmask != 0, code, upd)
    return upd.astype(F32)


def vector_dist_euc(
    a: np.ndarray,
    b: np.ndarray,
    amask: Optional[np.ndarray] = None,
    bmask: Optional[np.ndarray] = None,
) -> float:
    """Euclidean distance: float32 accumulation, sqrt in double, result
    rounded to float32 (lvq_pak.c:291-316). -1 if everything masked."""
    acc = F32(0.0)
    masked = 0
    dim = a.shape[0]
    for i in range(dim):
        if (amask is not None and amask[i]) or (bmask is not None and bmask[i]):
            masked += 1
            continue
        diff = F32(a[i]) - F32(b[i])
        acc = F32(acc + diff * diff)
    if masked == dim:
        return -1.0
    return float(F32(np.sqrt(np.float64(acc))))


def pairwise_dist_euc(
    X: np.ndarray, Y: np.ndarray, xmask=None, ymask=None
) -> np.ndarray:
    """(N, M) float32 euclidean distances (sqrt of the float32 seq-accum
    squared distance, via double sqrt) — vectorized vector_dist_euc."""
    N, dim = X.shape
    acc = np.zeros((N, Y.shape[0]), dtype=F32)
    for i in range(dim):
        diff = X[:, None, i] - Y[None, :, i]
        d2 = diff * diff
        if xmask is not None:
            d2 = np.where(xmask[:, None, i] != 0, F32(0.0), d2)
        if ymask is not None:
            d2 = np.where(ymask[None, :, i] != 0, F32(0.0), d2)
        acc = acc + d2
    return np.sqrt(acc.astype(np.float64)).astype(F32)
