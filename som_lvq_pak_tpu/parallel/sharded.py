"""Sharded winner search and training steps over a (data, model) mesh.

Design (SURVEY.md §2.6, §7 layer 4 — all new; the reference has no
parallelism):

* codebook rows sharded on the `model` axis; each device runs the
  selected winner op (ops.dispatch.find_bmu) over its shard and the
  global winner is resolved with an all_gather of (local_min,
  global_index) candidate pairs over the model axis — S candidates per
  sample, S = model-axis size, so the collective moves only O(B*S)
  scalars.  Tie-break: lowest global index among equal distances (the C
  scan's first-index rule, lvq_pak.c:79).
* the batch is sharded on the `data` axis; each data shard computes its
  local W^T X / W^T 1 update accumulators for its own codebook rows
  (ops.dispatch.som_accumulate, with the shard's global unit offset),
  combined with a psum over `data` — the framework's only other
  collective.
* each model shard then blends its own codebook rows locally: no
  (noc, noc) matrix and no cross-shard traffic for the update.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import dispatch


def sharded_winner_search(xb, codes_local, n_local: int, mask=None):
    """Inside shard_map: global (val, index) winners for the local batch
    shard against the model-sharded codebook.

    Returns (val (Bl,), global_idx (Bl,)). Must be called under a mesh
    with axes ('data', 'model').  `mask` (Bl, D) nonzero = component
    masked off (lvq_pak.c:63-72)."""
    idx_l, val_l = dispatch.find_bmu(xb, codes_local, mask)
    shard = jax.lax.axis_index("model")
    gidx_l = idx_l.astype(jnp.int32) + shard.astype(jnp.int32) * n_local
    vals = jax.lax.all_gather(val_l, "model")  # (S, Bl)
    gidxs = jax.lax.all_gather(gidx_l, "model")  # (S, Bl)
    best_val = jnp.min(vals, axis=0)
    cand = jnp.where(vals == best_val[None, :], gidxs, jnp.iinfo(jnp.int32).max)
    best_idx = jnp.min(cand, axis=0)  # lowest global index wins ties
    return best_val, best_idx


def sharded_som_step(
    codes_local, xb_local, alpha, radius,
    gaussian: bool, xdim: int, hexa: bool,
    mask_local=None, weights_local=None, fixed_local=None,
    overlap_chunks: int = 1,
):
    """One sharded minibatch SOM step (runs inside shard_map).

    codes_local: (noc/S, D) on the model axis
    xb_local:    (B/Dd, D) on the data axis
    mask_local / weights_local / fixed_local: optional per-sample shards
    on the data axis — mask (Bl, D) nonzero = comp masked, weights (Bl,)
    scale alpha as 1-(1-a)^w, fixed (Bl,) int32 >= 0 bypasses winner
    search (som_rout.c:612-640 on the batch path).
    """
    n_local = codes_local.shape[0]
    if mask_local is not None:
        keep = 1.0 - mask_local.astype(jnp.float32)
        _, bmu = sharded_winner_search(xb_local * keep, codes_local, n_local,
                                       mask=mask_local)
    elif overlap_chunks > 1:
        # collective/compute pipelining: split the batch so chunk k's
        # winner all_gather can run while chunk k+1's distance search
        # runs.  Exactly the same math as the unchunked search (winners
        # are per-sample independent) — the split only gives XLA's
        # latency-hiding scheduler the freedom to overlap.
        Bl = xb_local.shape[0]
        k = max(1, min(overlap_chunks, Bl))
        csize = -(-Bl // k)
        parts = [sharded_winner_search(xb_local[s:s + csize], codes_local,
                                       n_local)[1]
                 for s in range(0, Bl, csize)]
        bmu = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    else:
        _, bmu = sharded_winner_search(xb_local, codes_local, n_local)
    if fixed_local is not None:
        bmu = jnp.where(fixed_local >= 0, fixed_local, bmu)
    # per-sample effective alpha (weight= scaling; empty samples -> 0)
    a = jnp.broadcast_to(jnp.asarray(alpha, jnp.float32), xb_local.shape[:1])
    if weights_local is not None:
        w = jnp.where(weights_local > 0.0, weights_local, 1.0).astype(jnp.float32)
        a = 1.0 - jnp.power(1.0 - a, w)
    if mask_local is not None:
        a = jnp.where(jnp.all(mask_local != 0, axis=-1), 0.0, a)
    shard = jax.lax.axis_index("model").astype(jnp.int32)
    wx, wsum = dispatch.som_accumulate(
        xb_local, bmu, a, radius, n_rows=n_local, xdim=xdim, hexa=hexa,
        gaussian=gaussian, unit_offset=shard * n_local, mask=mask_local)
    # combine partial accumulators over the data axis
    wx = jax.lax.psum(wx, "data")
    wsum = jax.lax.psum(wsum, "data")
    return dispatch.guarded_blend(codes_local, wx, wsum)


def sharded_olvq1_step(
    codes_local, labels_full, alphas_full, xb_local, xlab_local, clip: float,
):
    """One sharded minibatch olvq1 step (runs inside shard_map).

    codes_local: (noc/S, D) sharded on `model`
    labels_full: (noc,) int32 code labels, replicated (tiny)
    alphas_full: (noc,) per-code learning rates, replicated — the update
                 counts are identical on every model shard, so the
                 replicated alpha state stays consistent without a
                 collective over `model`
    xb_local:    (B/Dd, D) sharded on `data` (replicated over `model`)

    Update math matches models.fast.olvq1_batch_step: winners sharing a
    code within the batch accumulate, alpha recurrences apply once per
    hit-count (a/(1+k a), clipped a/(1-k a))."""
    n_local = codes_local.shape[0]
    noc = labels_full.shape[0]
    _, gidx = sharded_winner_search(xb_local, codes_local, n_local)

    correct = labels_full[gidx] == xlab_local  # (Bl,)
    a = alphas_full[gidx]
    sign = jnp.where(correct, a, -a)

    shard = jax.lax.axis_index("model").astype(jnp.int32)
    lidx = gidx - shard * n_local
    in_local = (lidx >= 0) & (lidx < n_local)
    lidx_c = jnp.clip(lidx, 0, n_local - 1)
    contrib = jnp.where(in_local, sign, 0.0)[:, None] * (xb_local - codes_local[lidx_c])
    delta = jax.ops.segment_sum(contrib, lidx_c, num_segments=n_local)
    delta = jax.lax.psum(delta, "data")

    # per-code hit counts over the FULL index space; every model shard
    # computes the same value, so only the data axis needs a psum
    ncorrect = jax.lax.psum(
        jax.ops.segment_sum(correct.astype(jnp.float32), gidx, num_segments=noc),
        "data",
    )
    nwrong = jax.lax.psum(
        jax.ops.segment_sum((~correct).astype(jnp.float32), gidx, num_segments=noc),
        "data",
    )
    # saturating alpha growth — see models.fast.olvq1_batch_step: the
    # closed form a/(1-k a) blows up when k*a >= 1, so clip-saturate
    new_a = alphas_full / (1.0 + ncorrect * alphas_full)
    denom = 1.0 - nwrong * new_a
    grown = jnp.where(denom > 1e-6, new_a / jnp.where(denom > 1e-6, denom, 1.0), clip)
    new_a = jnp.where(nwrong > 0, jnp.minimum(grown, clip), new_a)
    return codes_local + delta, new_a


def make_sharded_olvq1_train_step(mesh: Mesh, clip: float = 0.3) -> Callable:
    """step(codes (noc,D), labels (noc,), alphas (noc,), xb (B,D),
    xlabels (B,)) -> (codes, alphas); codes sharded P('model', None),
    batch P('data')."""
    fn = functools.partial(sharded_olvq1_step, clip=clip)
    smapped = jax.shard_map(
        lambda c, l, a, x, xl: fn(c, l, a, x, xl),
        mesh=mesh,
        check_vma=False,
        in_specs=(P("model", None), P(), P(), P("data", None), P("data")),
        out_specs=(P("model", None), P()),
    )
    return jax.jit(smapped)


def dim_sharded_winner_search(xb_d, codes_d, axis: str = "model",
                              chunk: int = 2048):
    """Feature-axis-sharded winner search — the sequence-parallel
    analogue for very high-dimensional vectors (SURVEY.md §2.6): X and M
    are sharded along D, each chip computes the partial contraction
    -2 X_d M_d^T + ||M_d||^2, the partial distances are psum'd over the
    feature axis, and the argmin is local.  Moves O(B*N) floats over ICI
    instead of gathering O(N*D) codebook columns.

    The codebook is processed in `chunk`-row tiles inside a lax.scan:
    each round psums one (B, chunk) partial-distance block and folds it
    into the running (min, argmin) — peak memory O(B*chunk) per chip,
    never the full (B, N) block, so a 65 k codebook at real batch sizes
    fits HBM.  Tie-break: strict < across chunks + argmin inside a chunk
    = lowest global index first (the C scan rule, lvq_pak.c:79).

    Returns (sq_dist_without_x2 (B,), idx (B,)) — like the C scan, the
    ||x||^2 constant is dropped (it cannot change the argmin)."""
    N = codes_d.shape[0]
    B = xb_d.shape[0]
    chunk = min(chunk, N)
    nchunks = -(-N // chunk)
    Np = nchunks * chunk
    mp = codes_d
    bias = jnp.zeros((Np,), jnp.float32)
    if Np != N:
        mp = jnp.zeros((Np, codes_d.shape[1]), codes_d.dtype).at[:N].set(codes_d)
        bias = bias.at[N:].set(jnp.inf)  # padded rows can never win
    chunks = mp.reshape(nchunks, chunk, -1)
    biases = bias.reshape(nchunks, chunk)

    def fold(carry, inp):
        bestv, besti, base = carry
        m_c, b_c = inp
        partial = jnp.sum(m_c * m_c, axis=-1)[None, :] - 2.0 * jax.lax.dot_general(
            xb_d, m_c, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # (B, chunk) partial over local feature slice
        d = jax.lax.psum(partial, axis) + b_c[None, :]
        v = jnp.min(d, axis=-1)
        i = jnp.argmin(d, axis=-1).astype(jnp.int32) + base
        better = v < bestv
        return (jnp.where(better, v, bestv), jnp.where(better, i, besti),
                base + chunk), None

    init = (jnp.full((B,), jnp.inf, jnp.float32),
            jnp.zeros((B,), jnp.int32), jnp.int32(0))
    (val, idx, _), _ = jax.lax.scan(fold, init, (chunks, biases))
    return val, idx


def make_dim_sharded_winner(mesh: Mesh, chunk: int = 2048) -> Callable:
    """winner(xb (B, D), codes (N, D)) with the feature axis sharded over
    `model` and the batch over `data`."""
    smapped = jax.shard_map(
        functools.partial(dim_sharded_winner_search, chunk=chunk),
        mesh=mesh,
        check_vma=False,
        in_specs=(P("data", "model"), P(None, "model")),
        out_specs=(P("data"), P("data")),
    )
    return jax.jit(smapped)


def make_sharded_som_train_step(
    mesh: Mesh, gaussian: bool, xdim: int, hexa: bool,
    masked: bool = False, weighted: bool = False, fixed: bool = False,
    overlap_chunks: int = 1,
) -> Callable:
    """Build a jitted sharded train step:
    step(codes (noc, D), xb (B, D), alpha, radius, [mask (B, D)],
    [weights (B,)], [fixed_bmu (B,)]) -> codes, with codes sharded
    P('model', None), per-sample arrays P('data', ...).  The optional
    trailing args appear in that order for whichever of
    masked/weighted/fixed are True.  `xdim`/`hexa` give the map's grid
    (the update computes grid distances from unit indices)."""
    fn = functools.partial(sharded_som_step, gaussian=gaussian, xdim=xdim,
                           hexa=hexa, overlap_chunks=overlap_chunks)
    in_specs = [
        P("model", None),  # codebook rows
        P("data", None),  # batch rows
        P(),  # alpha
        P(),  # radius
    ]
    kw_order = []
    if masked:
        in_specs.append(P("data", None))
        kw_order.append("mask_local")
    if weighted:
        in_specs.append(P("data"))
        kw_order.append("weights_local")
    if fixed:
        in_specs.append(P("data"))
        kw_order.append("fixed_local")

    def call(c, x, a, r, *extras):
        return fn(c, x, a, r, **dict(zip(kw_order, extras)))

    smapped = jax.shard_map(
        call,
        mesh=mesh,
        check_vma=False,
        in_specs=tuple(in_specs),
        out_specs=P("model", None),
    )
    return jax.jit(smapped)


def shard_arrays(mesh: Mesh, codes, xb):
    """Place the codebook and a batch with the training-step shardings."""
    cs = jax.device_put(codes, NamedSharding(mesh, P("model", None)))
    xs = jax.device_put(xb, NamedSharding(mesh, P("data", None)))
    return cs, xs


# ---------------------------------------------------------------------------
# Expert parallelism: class-blocked codebook layout (SURVEY.md §2.6 EP row)
# ---------------------------------------------------------------------------

class ClassBlockedOLVQ1:
    """olvq1 training with the expert-parallel codebook layout: rows are
    permuted so same-class codes sit in contiguous blocks
    (parallel.mesh.class_blocked_order) before sharding over the `model`
    axis, landing each class on as few shards as possible — per-class
    work (quota rebalancing, class statistics, per-class eval) then
    touches a minimal shard set, the EP analogue for a model with no MoE
    layer (the reference has no parallelism at all; this is new design).

    Training math is exactly the sharded olvq1 step (winners over the
    permuted layout are the same vectors, so trained codebooks match the
    unpermuted run up to the row permutation, which `codes()` undoes)."""

    def __init__(self, mesh: Mesh, codes, code_labels, alphas=None,
                 clip: float = 0.3):
        import numpy as np

        from .mesh import class_blocked_order

        self.mesh = mesh
        labels = np.asarray(code_labels)
        self.order = class_blocked_order(labels)
        self.inv = np.argsort(self.order)
        self._step = make_sharded_olvq1_train_step(mesh, clip=clip)
        n = labels.shape[0]
        if alphas is None:
            alphas = jnp.full((n,), clip, dtype=jnp.float32)
        self._codes = jax.device_put(
            jnp.asarray(codes)[self.order],
            NamedSharding(mesh, P("model", None)),
        )
        self._labels = jnp.asarray(labels[self.order])
        self._alphas = jnp.asarray(alphas)[jnp.asarray(self.order)]

    def step(self, xb, xlabels):
        """One sharded minibatch olvq1 step over the blocked layout."""
        xs = jax.device_put(xb, NamedSharding(self.mesh, P("data", None)))
        xl = jax.device_put(xlabels, NamedSharding(self.mesh, P("data")))
        self._codes, self._alphas = self._step(
            self._codes, self._labels, self._alphas, xs, xl
        )
        return self

    def codes(self):
        """Trained codebook in the ORIGINAL row order."""
        return jnp.asarray(self._codes)[jnp.asarray(self.inv)]

    def alphas(self):
        return jnp.asarray(self._alphas)[jnp.asarray(self.inv)]

    def shards_per_class(self):
        """Diagnostic: {class label: number of model shards its rows
        span} under the blocked layout — the quantity EP minimizes."""
        import numpy as np

        n = len(self.order)
        s = self.mesh.shape["model"]
        per = -(-n // s)
        lab = np.asarray(self._labels)
        out = {}
        for c in np.unique(lab):
            rows = np.nonzero(lab == c)[0]
            out[int(c)] = len(np.unique(rows // per))
        return out


# ---------------------------------------------------------------------------
# Ring-pass winner search (the ring-attention analogue, SURVEY.md §5:
# codebooks too large for any single chip's HBM)
# ---------------------------------------------------------------------------

def ring_winner_search(xb_local, codes_local, axis: str = "model"):
    """Inside shard_map: winner search where BOTH the batch and the
    codebook stay sharded — nothing is ever replicated or gathered.

    Each chip holds a batch shard (Bl, D) and a codebook shard
    (noc/S, D).  The codebook shards rotate around the `axis` ring via
    ppermute: after round r a chip holds shard (me + r) % S, scores its
    local batch against it, and folds the (min, argmin) — S rounds visit
    every shard.  Per-chip memory stays O(Bl*D + (noc/S)*D); total ICI
    traffic is one full codebook circulation per batch, overlapping the
    next round's distance matmul.  This is the path for codebooks larger
    than one chip's HBM (the reference's only answer was LOADMODE_BUFFER
    on the data side; the codebook always had to fit RAM).

    Tie-break: lowest GLOBAL index among equal distances (the C scan's
    first-index rule, lvq_pak.c:79) — distances for a given (sample,
    code) pair are bit-identical whichever round computes them, so the
    (strict <) | (== and lower index) fold is exact.

    Returns (val (Bl,), global_idx (Bl,)) — true squared distances."""
    from ..ops.distance import find_winners

    S = jax.lax.axis_size(axis)
    me = jax.lax.axis_index(axis)
    n_local = codes_local.shape[0]
    Bl = xb_local.shape[0]
    perm = [(i, (i - 1) % S) for i in range(S)]  # pass blocks "left"

    def round_fn(carry, r):
        block, bestv, besti = carry
        owner = jax.lax.rem(me + r, S)
        idx, val = find_winners(xb_local, block)
        gidx = owner.astype(jnp.int32) * n_local + idx.astype(jnp.int32)
        better = (val < bestv) | ((val == bestv) & (gidx < besti))
        bestv = jnp.where(better, val, bestv)
        besti = jnp.where(better, gidx, besti)
        block = jax.lax.ppermute(block, axis, perm)
        return (block, bestv, besti), None

    init = (codes_local,
            jnp.full((Bl,), jnp.inf, jnp.float32),
            jnp.full((Bl,), jnp.iinfo(jnp.int32).max, jnp.int32))
    (block, bestv, besti), _ = jax.lax.scan(
        round_fn, init, jnp.arange(S, dtype=jnp.int32))
    return bestv, besti


def make_ring_winner(mesh: Mesh) -> Callable:
    """winner(xb (B, D), codes (noc, D)): batch sharded over BOTH mesh
    axes (maximal memory spread), codebook rows over `model`; winners
    resolved by the ring pass."""
    smapped = jax.shard_map(
        ring_winner_search,
        mesh=mesh,
        check_vma=False,
        in_specs=(P(("data", "model"), None), P("model", None)),
        out_specs=(P(("data", "model")), P(("data", "model"))),
    )
    return jax.jit(smapped)


# ---------------------------------------------------------------------------
# Sharded fixed-alpha LVQ steps (lvq1 / lvq2.1 / lvq3)
# ---------------------------------------------------------------------------

def sharded_top2(xb_local, codes_local, n_local: int):
    """Inside shard_map: global top-2 (distances, global indices) for the
    local batch shard against the model-sharded codebook.  Per shard:
    local top-2; merge: all_gather of S (2 val, 2 gidx) candidate pairs,
    then two selection passes (distance asc, lowest global index on
    ties — lax.top_k's convention, matching models.fast.lvq23_batch_step).
    Returns (d1, i1, d2, i2), each (Bl,)."""
    idx, vals = dispatch.find_top2(xb_local, codes_local)
    shard = jax.lax.axis_index("model").astype(jnp.int32)
    gidx = idx.astype(jnp.int32) + shard * n_local
    vs = jax.lax.all_gather(vals, "model", axis=1)   # (Bl, S, 2)
    gs = jax.lax.all_gather(gidx, "model", axis=1)   # (Bl, S, 2)
    Bl = vs.shape[0]
    vs = vs.reshape(Bl, -1)                          # (Bl, 2S)
    gs = gs.reshape(Bl, -1)

    def pick(vs, gs):
        best = jnp.min(vs, axis=1)                   # (Bl,)
        cand = jnp.where(vs == best[:, None], gs, jnp.iinfo(jnp.int32).max)
        bidx = jnp.min(cand, axis=1)
        return best, bidx

    d1, i1 = pick(vs, gs)
    vs2 = jnp.where(gs == i1[:, None], jnp.inf, vs)  # drop the winner
    d2, i2 = pick(vs2, gs)
    return d1, i1, d2, i2


def sharded_lvq_step(
    codes_local, labels_full, xb_local, xlab_local, alpha,
    algorithm: str, winlen: float, epsilon: float,
):
    """One sharded minibatch lvq1/lvq2.1/lvq3 step (inside shard_map).
    Update math matches models.fast.lvq1_batch_step / lvq23_batch_step;
    each model shard applies only the updates landing on its own rows
    (the winner's vector is read from the owning shard's local slice),
    data-axis partials combined with one psum — the same layout as
    sharded_olvq1_step."""
    n_local = codes_local.shape[0]
    shard = jax.lax.axis_index("model").astype(jnp.int32)
    off = shard * n_local

    def local_delta(gidx, coef):
        """segment-sum coef * (x - codes[gidx]) into local rows."""
        lidx = gidx - off
        in_local = (lidx >= 0) & (lidx < n_local)
        lidx_c = jnp.clip(lidx, 0, n_local - 1)
        contrib = jnp.where(in_local, coef, 0.0)[:, None] * (
            xb_local - codes_local[lidx_c])
        return jax.ops.segment_sum(contrib, lidx_c, num_segments=n_local)

    if algorithm == "lvq1":
        _, gidx = sharded_winner_search(xb_local, codes_local, n_local)
        correct = labels_full[gidx] == xlab_local
        sign = jnp.where(correct, alpha, -alpha)
        delta = local_delta(gidx, sign)
    else:
        d1, i1, d2, i2 = sharded_top2(xb_local, codes_local, n_local)
        l1, l2 = labels_full[i1], labels_full[i2]
        wl = (1.0 - winlen) / (1.0 + winlen)
        in_window = d1 / jnp.maximum(d2, 1e-30) > wl
        differ = l1 != l2
        one_matches = (l1 == xlab_local) | (l2 == xlab_local)
        window_rule = differ & one_matches & in_window
        swap = l2 == xlab_local
        b_idx = jnp.where(swap, i2, i1)
        nb_idx = jnp.where(swap, i1, i2)
        a_b = jnp.where(window_rule, alpha, 0.0)
        delta = local_delta(b_idx, a_b) + local_delta(nb_idx, -a_b)
        if algorithm == "lvq3":
            same = (l1 == l2) & (l1 == xlab_local)
            ae = jnp.where(same, alpha * epsilon, 0.0)
            delta = delta + local_delta(i1, ae) + local_delta(i2, ae)
    delta = jax.lax.psum(delta, "data")
    return codes_local + delta


def make_sharded_lvq_train_step(
    mesh: Mesh, algorithm: str = "lvq1", winlen: float = 0.3,
    epsilon: float = 0.1,
) -> Callable:
    """step(codes (noc, D) P('model', None), labels (noc,) replicated,
    xb (B, D) P('data', None), xlabels (B,) P('data'), alpha) -> codes.
    The TP/DP layout of make_sharded_olvq1_train_step for the
    fixed-alpha LVQ family (lvqtrain.c:214-237's lvq1/lvq2/lvq3)."""
    if algorithm not in ("lvq1", "lvq2", "lvq3"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    fn = functools.partial(sharded_lvq_step, algorithm=algorithm,
                           winlen=winlen, epsilon=epsilon)
    smapped = jax.shard_map(
        lambda c, l, x, xl, a: fn(c, l, x, xl, a),
        mesh=mesh,
        check_vma=False,
        in_specs=(P("model", None), P(), P("data", None), P("data"), P()),
        out_specs=P("model", None),
    )
    jitted = jax.jit(smapped)
    if algorithm == "lvq1":
        return jitted
    n_shards = mesh.shape["model"]

    def checked(codes, labels, xb, xlabels, alpha):
        # lvq2/lvq3 run a per-shard local top-2 (sharded_top2): a model
        # shard holding < 2 codebook rows cannot produce two candidates
        # (the top-2 search needs two rows per shard)
        if codes.shape[0] < 2 * n_shards:
            raise ValueError(
                f"sharded {algorithm}: every model shard needs >= 2 "
                f"codebook rows for the local top-2 — got noc="
                f"{codes.shape[0]} over {n_shards} model shards")
        return jitted(codes, labels, xb, xlabels, alpha)

    return checked
