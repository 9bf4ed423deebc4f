"""Minibatch training steps — the production throughput path.

The reference trains strictly online (one sample per step,
som_rout.c:600, lvq_rout.c:637).  On the device the unit of work becomes
a minibatch: one winner search finds B winners at once, and the
neighborhood/winner updates collapse into a second matmul (W^T X) — a
training step is two contractions (ops.dispatch picks how each runs).
This deviates from the reference's sequential-update semantics
(documented; the parity trainers in som.py/lvq.py preserve them exactly); for small learning rates the accumulated-update batch is
a first-order approximation of B online steps, and `update='mean'`
implements the classic Kohonen batch-SOM rule instead.

Grid distances are computed closed-form from unit indices (hexa
geometry: odd-row x offset +-0.5, y scaled sqrt(0.75), som_rout.c:434-455)
instead of gathering rows of a (noc, noc) matrix — works for maps of any
size.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.dataset import Dataset, Neighborhood, Topology
from ..ops import dispatch
from .common import alpha_schedule, radius_schedule


def unit_coords(xdim: int, ydim: int, hexa: bool) -> jnp.ndarray:
    """(noc, 2) float32 effective grid coordinates.

    For hexa maps the C pairwise formula (som_rout.c:434-455) is
    equivalent to embedding odd rows at x+0.5 and scaling y by
    sqrt(0.75), then taking plain euclidean distance.
    """
    idx = np.arange(xdim * ydim)
    x = (idx % xdim).astype(np.float32)
    y = (idx // xdim).astype(np.float32)
    if hexa:
        x = x + 0.5 * ((idx // xdim) % 2)
        y = y * np.float32(np.sqrt(0.75))
    return jnp.asarray(np.stack([x, y], axis=1))


def grid_sq_dists(coords: jnp.ndarray, bmu: jnp.ndarray) -> jnp.ndarray:
    """(B, noc) squared grid distances from each BMU to every unit."""
    c = coords[bmu]  # (B, 2)
    d = c[:, None, :] - coords[None, :, :]
    return jnp.sum(d * d, axis=-1)


def neighborhood_matrix(
    coords: jnp.ndarray,
    bmu: jnp.ndarray,
    radius: jnp.ndarray,
    alpha: jnp.ndarray,
    gaussian: bool,
) -> jnp.ndarray:
    """(B, noc) adaptation weights (bubble: som_rout.c:472-506,
    gaussian: :511-549).  `alpha` may be a scalar or a per-sample (B,)
    vector (weight= scaling, empty-sample zeroing)."""
    d2 = grid_sq_dists(coords, bmu)
    a = jnp.asarray(alpha, dtype=jnp.float32)
    if a.ndim == 1:
        a = a[:, None]
    if gaussian:
        return a * jnp.exp(-d2 / (2.0 * radius * radius))
    return jnp.where(d2 <= radius * radius, a, 0.0)


@functools.partial(jax.jit, static_argnames=("gaussian", "update", "xdim", "hexa"))
def som_batch_step(
    codes: jnp.ndarray,
    xb: jnp.ndarray,
    coords: jnp.ndarray,
    alpha,
    radius,
    gaussian: bool = False,
    update: str = "sum",
    xdim: Optional[int] = None,
    hexa: bool = True,
    mask: Optional[jnp.ndarray] = None,
    weights: Optional[jnp.ndarray] = None,
    fixed_bmu: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """One minibatch SOM step: winner search, then the W^T X update.

    update='sum':  codes += sum_b W_bj (x_b - m_j)   (accumulated online,
                   saturating-guarded — see ops.dispatch.guarded_blend)
    update='mean': blend toward (W^T X)_j / (W^T 1)_j  (batch SOM)
    With the guard the two coincide: 'sum' is exact accumulation while a
    unit's weight mass <= 1 and saturates at the 'mean' target beyond.

    Reference training-loop semantics carried onto the batch path
    (som_rout.c:612-640): `weights` (B,) scales each sample's alpha as
    1-(1-a)^w; `fixed_bmu` (B,) int32 >= 0 bypasses winner search for
    fixed-point samples; `mask` (B, D) excludes masked comps from both
    the winner distance and the update, and all-masked (empty) samples
    are skipped.

    Pass static `xdim`/`hexa`: the update op then computes grid
    distances from the BMU indices and never needs `coords`; without
    them W is built from the coordinate table.
    """
    # per-sample effective alpha (som_rout.c:622-624); empty samples -> 0
    a = jnp.broadcast_to(jnp.asarray(alpha, dtype=jnp.float32), xb.shape[:1])
    if weights is not None:
        w = jnp.where(weights > 0.0, weights, 1.0).astype(jnp.float32)
        a = 1.0 - jnp.power(1.0 - a, w)
    if mask is not None:
        a = jnp.where(jnp.all(mask != 0, axis=-1), 0.0, a)

    bmu, _ = dispatch.find_bmu(xb, codes, mask)
    if fixed_bmu is not None:
        bmu = jnp.where(fixed_bmu >= 0, fixed_bmu, bmu)
    if xdim is not None:
        return dispatch.som_update(codes, xb, bmu, a, radius, xdim=xdim,
                                   hexa=hexa, gaussian=gaussian, mask=mask)
    W = neighborhood_matrix(coords, bmu, radius, a, gaussian)  # (B, noc)
    dims = (((0,), (0,)), ((), ()))
    if mask is not None:
        keep = 1.0 - mask.astype(jnp.float32)
        wx = jax.lax.dot_general(W, xb * keep, dims,
                                 preferred_element_type=jnp.float32)
        wsum = jax.lax.dot_general(W, keep, dims,
                                   preferred_element_type=jnp.float32)
    else:
        wx = jax.lax.dot_general(W, xb, dims, preferred_element_type=jnp.float32)
        wsum = jnp.sum(W, axis=0)[:, None]
    return dispatch.guarded_blend(codes, wx, wsum)


@jax.jit
def olvq1_batch_step(
    codes: jnp.ndarray,
    code_labels: jnp.ndarray,
    alphas: jnp.ndarray,
    xb: jnp.ndarray,
    xlabels: jnp.ndarray,
    clip: float = 0.3,
    mask: Optional[jnp.ndarray] = None,
):
    """One minibatch olvq1 step: winners for B samples, signed
    segment-sum update, per-code alpha adaptation (lvq_rout.c:650-673
    batched; winners sharing a code within the batch accumulate).
    `mask` (B, D) excludes masked comps from the winner distance and the
    update (lvq_pak.c:63-72, :349-356)."""
    bmu, _ = dispatch.find_bmu(xb, codes, mask)
    noc = codes.shape[0]
    correct = code_labels[bmu] == xlabels  # (B,)
    a = alphas[bmu]
    sign = jnp.where(correct, a, -a)  # (B,)
    delta = sign[:, None] * (xb - codes[bmu])
    if mask is not None:
        delta = jnp.where(mask != 0, 0.0, delta)
    upd = jax.ops.segment_sum(delta, bmu, num_segments=noc)
    ncorrect = jax.ops.segment_sum(correct.astype(jnp.float32), bmu, num_segments=noc)
    nwrong = jax.ops.segment_sum((~correct).astype(jnp.float32), bmu, num_segments=noc)
    # apply the alpha recurrences once per hit: a/(1+a) applied k times
    # equals a/(1+k a); a/(1-a) likewise, but its closed form blows up
    # when k*a >= 1 — the sequential reference clips after EVERY sample
    # (lvq_rout.c:668-672) so alpha stays in (0, clip]; saturate to clip
    # whenever the batched denominator leaves that regime
    new_a = alphas / (1.0 + ncorrect * alphas)
    denom = 1.0 - nwrong * new_a
    grown = jnp.where(denom > 1e-6, new_a / jnp.where(denom > 1e-6, denom, 1.0), clip)
    new_a = jnp.where(nwrong > 0, jnp.minimum(grown, clip), new_a)
    return codes + upd, new_a


@jax.jit
def lvq1_batch_step(
    codes: jnp.ndarray,
    code_labels: jnp.ndarray,
    xb: jnp.ndarray,
    xlabels: jnp.ndarray,
    alpha,
    mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """One minibatch lvq1 step: signed segment-sum toward/away from the
    winner (lvq1_training, lvq_rout.c:498-577 batched); `mask` as in
    olvq1_batch_step."""
    bmu, _ = dispatch.find_bmu(xb, codes, mask)
    noc = codes.shape[0]
    correct = code_labels[bmu] == xlabels
    sign = jnp.where(correct, alpha, -alpha)
    delta = sign[:, None] * (xb - codes[bmu])
    if mask is not None:
        delta = jnp.where(mask != 0, 0.0, delta)
    return codes + jax.ops.segment_sum(delta, bmu, num_segments=noc)


@functools.partial(jax.jit, static_argnames=("lvq3",))
def lvq23_batch_step(
    codes: jnp.ndarray,
    code_labels: jnp.ndarray,
    xb: jnp.ndarray,
    xlabels: jnp.ndarray,
    alpha,
    winlen,
    epsilon=0.0,
    lvq3: bool = False,
    mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """One minibatch lvq2.1/lvq3 step: fused top-2 winner search, the
    window predicate d1/d2 > (1-w)/(1+w), and the signed pair update
    (lvq_rout.c:702-916 batched).  lvq3 adds the same-class epsilon pull.
    `mask` as in olvq1_batch_step."""
    idx, vals = dispatch.find_top2(xb, codes, mask)
    i1, i2 = idx[:, 0], idx[:, 1]
    d1, d2 = vals[:, 0], vals[:, 1]
    noc = codes.shape[0]
    l1, l2 = code_labels[i1], code_labels[i2]
    wl = (1.0 - winlen) / (1.0 + winlen)
    in_window = d1 / jnp.maximum(d2, 1e-30) > wl

    differ = l1 != l2
    one_matches = (l1 == xlabels) | (l2 == xlabels)
    window_rule = differ & one_matches & in_window
    # orient: b = the code matching the sample's label
    swap = l2 == xlabels
    b_idx = jnp.where(swap, i2, i1)
    nb_idx = jnp.where(swap, i1, i2)
    a_b = jnp.where(window_rule, alpha, 0.0)
    keep = 1.0 if mask is None else (1.0 - mask.astype(jnp.float32))
    delta = jax.ops.segment_sum(
        a_b[:, None] * keep * (xb - codes[b_idx]), b_idx, num_segments=noc
    ) + jax.ops.segment_sum(
        -a_b[:, None] * keep * (xb - codes[nb_idx]), nb_idx, num_segments=noc
    )
    if lvq3:
        same = (l1 == l2) & (l1 == xlabels)
        ae = jnp.where(same, alpha * epsilon, 0.0)
        delta = delta + jax.ops.segment_sum(
            ae[:, None] * keep * (xb - codes[i1]), i1, num_segments=noc
        ) + jax.ops.segment_sum(
            ae[:, None] * keep * (xb - codes[i2]), i2, num_segments=noc
        )
    return codes + delta


def som_train_fast(
    codes: Dataset,
    data: Dataset,
    rlen: int,
    alpha: float,
    radius: float,
    batch_size: int = 1024,
    update: str = "sum",
    seed: int = 0,
) -> Dataset:
    """Minibatch SOM training driver: rlen counts *samples* like the
    reference, grouped into batches; schedules follow the reference decay
    evaluated at each batch's first sample."""
    from dataclasses import replace

    if not codes.is_map:
        raise ValueError("not a map codebook")
    gaussian = codes.neigh == Neighborhood.GAUSSIAN
    coords = unit_coords(codes.xdim, codes.ydim, codes.topol == Topology.HEXA)

    nb = max(1, rlen // batch_size)
    talp = alpha_schedule(rlen, alpha)[:: max(1, batch_size)][:nb]
    trad = radius_schedule(rlen, radius)[:: max(1, batch_size)][:nb]

    key = jax.random.PRNGKey(seed)
    X = jnp.asarray(data.points, jnp.float32)
    M = jnp.asarray(codes.points, jnp.float32)
    n = data.n

    steps = jax.random.randint(key, (nb, batch_size), 0, n)
    talp_j = jnp.asarray(talp)
    trad_j = jnp.asarray(trad)

    for b in range(nb):
        xb = X[steps[b]]
        M = som_batch_step(M, xb, coords, talp_j[b], trad_j[b],
                           gaussian=gaussian, update=update,
                           xdim=codes.xdim,
                           hexa=codes.topol == Topology.HEXA)
    return replace(codes, points=np.asarray(M), comments=[])
