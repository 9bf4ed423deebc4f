"""LVQ: trainers (lvq1/olvq1/lvq2.1/lvq3), initializers (eveninit/propinit,
pick, balance) and class statistics (min/median distances, deviations).

Reference behavior: lvq_rout.c (trainers :498-916, picking :85-239, class
stats :280-492,929-1004), eveninit.c:46-158, balance.c:44-226.

Like the SOM module, trainers offer mode='parity' (host float32, bit-exact
vs the C package — anchors the 90.11 % lvqexample golden) and mode='fast'
(jitted lax.scan; winner search as one matmul).  The kNN-based initializers
are computed with batched all-pairs distance evaluation instead of the
reference's O(N^2 * dim) scalar rescans — same results, matmul speed.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Tuple

import numpy as np

from ..data.dataset import Dataset, Topology
from ..ops import exact
from ..utils.hitlist import Hitlist, majority_label_matrix
from ..utils.rng import CRandom
from .common import ALPHA_LINEAR, alpha_schedule, sample_order

F32 = np.float32


# ---------------------------------------------------------------------------
# kNN correctness (the eveninit/balance work-horse)
# ---------------------------------------------------------------------------

def knn_correct_mask(data: Dataset, knn: int, mode: str = "parity") -> np.ndarray:
    """(N,) bool: is entry i correctly classified by kNN majority vote
    against the *whole* data set (itself included, at distance 0)?

    Replaces the reference's per-pick rescan correct_by_knn
    (lvq_rout.c:38-80) with one batched all-pairs computation.  Tie
    semantics preserved: neighbor order is (distance asc, index desc)
    (find_winner_knn insertion rule) and the majority vote follows the
    hitlist head rule (labels.c:278-443).
    """
    if knn < 1:
        knn = 1
    if mode == "fast":
        # device-chunked dist-matmul + top-k: same tie order, scales to
        # millions of vectors (O(chunk*N) peak memory)
        import jax.numpy as jnp

        from ..ops.distance import chunked_topk

        idx, _ = chunked_topk(
            jnp.asarray(data.points), jnp.asarray(data.points), knn,
            None if data.mask is None else jnp.asarray(data.mask),
        )
        idx = np.asarray(idx)
    else:
        # parity: the exact host path UNCONDITIONALLY (C accumulation
        # order at every size) — byte-for-byte eveninit/balance output
        # must not depend on the data size.  Use mode="fast" for
        # device-scale self-kNN (1M-vector workloads).
        idx, _ = exact.pairwise_topk(
            np.asarray(data.points), np.asarray(data.points), knn,
            None if data.mask is None else np.asarray(data.mask))
    labels = data.first_labels()
    neigh_labels = labels[idx]  # (N, knn)
    num = int(labels.max()) + 1
    win = majority_label_matrix(neigh_labels, num)
    return win == labels


def pick_inside_codes(
    quotas: Hitlist, data: Dataset, knn: int, correct: Optional[np.ndarray] = None
) -> List[int]:
    """Walk the data in order picking per-class quotas of vectors that
    are kNN-correct against the full set (lvq_rout.c:151-211).
    Returns the picked row indices in pick order.  Mutates `quotas`."""
    if correct is None:
        correct = knn_correct_mask(data, knn)
    labels = data.first_labels()
    total = sum(freq for _, freq in quotas.items())
    picked: List[int] = []
    for i in range(data.n):
        if total == 0:
            break
        cls = quotas.find_hit(int(labels[i]))
        if cls is not None and cls[1] > 0 and correct[i]:
            picked.append(i)
            cls[1] -= 1
            total -= 1
    return picked


def pick_codes(num: int, data: Dataset) -> Dataset:
    """First `num` entries as a codebook (pick_codes, lvq_rout.c:85-119;
    the `pick` tool).  Keeps the source header's topology (copy_entries
    semantics — a plain data file stays a plain data file)."""
    return data.take(np.arange(min(num, data.n)))


def eveninit(
    data: Dataset,
    noc: int,
    knn: int = 5,
    proportional: bool = False,
    mode: str = "parity",
) -> Dataset:
    """Initial LVQ codebook: per-class quotas (even, or proportional to
    class frequency for propinit), vectors must fall inside class borders
    (init_codes, eveninit.c:46-158).  mode='fast' routes the self-kNN
    correctness sweep through the device dist-matmul path (identical tie
    order, f32-matmul accumulation — for million-vector data)."""
    labels = data.first_labels()
    classes = Hitlist.from_labels(labels)
    nol = len(classes)
    tot = data.n
    nic = noc // nol

    for it in classes._items:
        if proportional:
            # C: freq = freq * (float)noc / tot, truncated to long, min 1
            q = int(F32(F32(it[1]) * F32(noc)) / F32(tot))
            it[1] = max(q, 1)
        else:
            it[1] = nic

    correct = knn_correct_mask(data, knn, mode=mode)
    picked = pick_inside_codes(classes, data, knn, correct)

    # second pass: redistribute the shortfall to classes that met their
    # quota (eveninit.c:114-144); fractional remainders carry over
    nom = len(picked)
    if nom < noc:
        emp = sum(1 for _, freq in classes.items() if freq == 0)
        frac = (noc - nom) / float(emp) if emp else 0.0
        err = 0.0
        for it in classes._items:
            if it[1] == 0:
                q = int(frac + err)
                err = frac + err - q
                it[1] = q
            else:
                it[1] = 0
        picked += pick_inside_codes(classes, data, knn, correct)

    out = data.take(np.asarray(picked, dtype=np.int64))
    out = replace(out, topol=Topology.LVQ)
    # codebooks keep only the class label of each picked vector
    if out.labels is not None:
        out.labels = out.labels[:, :1].copy()
    return out


# ---------------------------------------------------------------------------
# Class statistics (mindist/stddev/balance)
# ---------------------------------------------------------------------------

def class_nearest_stats(codes: Dataset, median: bool) -> Tuple[List[int], np.ndarray, np.ndarray]:
    """Per-class mean (min_distances, lvq_rout.c:280-369) or median
    (med_distances :384-492) of each member's nearest *subsequent*
    same-class neighbor distance.  Returns (class_labels_in_hitlist_order,
    dists, counts)."""
    labels = codes.first_labels()
    classes = Hitlist.from_labels(labels)
    dmat = exact.pairwise_dist_euc(codes.points, codes.points, codes.mask, codes.mask)
    cls_labels = [lab for lab, _ in classes.items()]
    noe = np.asarray([freq for _, freq in classes.items()], dtype=np.int64)
    dists = np.zeros(len(cls_labels), dtype=F32)
    for ci, lab in enumerate(cls_labels):
        members = np.nonzero(labels == lab)[0]
        per_member = []
        for a_pos, a in enumerate(members):
            later = members[a_pos + 1 :]
            if later.size == 0:
                continue
            per_member.append(dmat[a, later].min())
        if not per_member:
            continue
        arr = np.asarray(per_member, dtype=F32)
        if median:
            arr_sorted = np.sort(arr)
            dists[ci] = arr_sorted[len(arr_sorted) // 2]
        else:
            # C accumulates float32 in member order then divides by count
            s = F32(0.0)
            for v in arr:
                s = F32(s + v)
            dists[ci] = F32(s / F32(len(arr)))
    return cls_labels, dists, noe


def deviations(codes: Dataset, cls_labels: List[int], noe: np.ndarray) -> np.ndarray:
    """Per-class RMS deviation from the class centroid (lvq_rout.c:929-1004).
    Centroid sums skip masked components but divide by the class size."""
    labels = codes.first_labels()
    nol = len(cls_labels)
    dim = codes.dim
    avers = np.zeros((nol, dim), dtype=F32)
    for i in range(codes.n):
        ci = cls_labels.index(int(labels[i]))
        row = codes.points[i]
        if codes.mask is not None:
            keep = codes.mask[i] == 0
            avers[ci] = np.where(keep, (avers[ci] + row).astype(F32), avers[ci])
        else:
            avers[ci] = (avers[ci] + row).astype(F32)
    avers = (avers / noe[:, None].astype(F32)).astype(F32)
    devs = np.zeros(nol, dtype=F32)
    for i in range(codes.n):
        ci = cls_labels.index(int(labels[i]))
        d = (codes.points[i] - avers[ci]).astype(F32)
        s = F32(0.0)
        for v in (d * d).astype(F32):
            s = F32(s + v)
        devs[ci] = F32(devs[ci] + s)
    return np.sqrt((devs / noe.astype(F32)).astype(F32).astype(np.float64)).astype(F32)


BAL = 1.3  # balance.c:30


def balance(
    codes: Dataset,
    data: Dataset,
    knn: int = 5,
    alpha_file_out: Optional[str] = None,
    report=None,
) -> Dataset:
    """Rebalance per-class codebook counts using class-median distances,
    then one olvq1 pass over the data (balance_codes, balance.c:44-226).
    `report`: optional callable(line) receiving the per-class summary."""
    cls_labels, dists, noe = class_nearest_stats(codes, median=True)
    nol = len(cls_labels)
    noe = noe.copy()
    diff = np.zeros(nol, dtype=np.int64)

    # aver = float32 mean of medians over classes with >1 member
    s = F32(0.0)
    note = 0
    for i in range(nol):
        if noe[i] > 1:
            s = F32(s + dists[i])
            note += 1
    aver = F32(s / F32(note)) if note else F32(0.0)

    note = 0
    for i in range(nol):
        # C compares in double: aver > 1.3 * dists[i]
        if float(aver) > BAL * float(dists[i]) and noe[i] > 1:
            diff[i] -= 1
            note += 1
        if BAL * float(aver) < float(dists[i]):
            diff[i] += 1
            note -= 1
    # (force-pick for empty classes, balance.c:109-121, is unreachable:
    #  the class list is built from the codebook so freq >= 1 always)
    for i in range(nol):
        if float(aver) > BAL * float(dists[i]) and (noe[i] + diff[i]) > 1:
            if note < 0:
                diff[i] -= 1
                note += 1
        if BAL * float(aver) < float(dists[i]):
            if note > 0:
                diff[i] += 1
                note -= 1

    # remove entries from classes with negative diff (file order scan)
    labels = codes.first_labels()
    keep = np.ones(codes.n, dtype=bool)
    rem = {cls_labels[i]: -int(d) for i, d in enumerate(diff) if d < 0}
    for i in range(codes.n):
        lab = int(labels[i])
        if rem.get(lab, 0) > 0:
            keep[i] = False
            rem[lab] -= 1
    kept = codes.take(np.nonzero(keep)[0])

    # pick additional inside-border vectors for positive diffs
    more = Hitlist()
    for i in range(nol):
        for _ in range(int(diff[i])):
            more.add_hit(cls_labels[i])
    picked = pick_inside_codes(more, data, knn)

    # the reference forgets to bump num_entries for the appended picks
    # (balance.c:187 'laske montako uutta'), so its olvq1 pass sizes the
    # alpha array and the .lra sidecar by the stale count.  The sidecar
    # length is observable file behavior (a short .lra makes the next
    # olvq1's alpha_read fail and fall back to 0.3) — replicate it.
    stale_noc = kept.n

    if picked:
        add = data.take(np.asarray(picked, dtype=np.int64))
        add = replace(add, topol=kept.topol)
        if add.labels is not None:
            add.labels = add.labels[:, :1].copy()
        kept = kept.concat(add)

    # one olvq1 pass: rlen = |data|, alpha = 0.3 (balance.c:195-202);
    # appended codes are frozen by the stale-count alpha array (see
    # olvq1_train's n_active)
    out, alphas = olvq1_train(
        kept, data, rlen=data.n, alpha=0.3, return_alphas=True, n_active=stale_noc
    )
    if alpha_file_out is not None:
        from ..data.io import write_alpha_file

        write_alpha_file(alpha_file_out, alphas[:stale_noc])

    if report is not None:
        cls2, dists2, noe2 = class_nearest_stats(out, median=True)
        from ..data.labels import GLOBAL_LABELS

        for lab, d, ne in zip(cls2, dists2, noe2):
            report(
                "In class %9s %3d units, min dist.: %.3f"
                % (GLOBAL_LABELS.to_label(lab), ne, d)
            )
    return out


# ---------------------------------------------------------------------------
# Trainers — parity path
# ---------------------------------------------------------------------------

def _train_setup(codes, data, rlen, random_order, rng, buffer=0):
    if codes.dim != data.dim:
        raise ValueError("data and codebook dimensions differ")
    order = sample_order(data.n, rlen, random_order, rng, buffer=buffer)
    return order


def lvq1_train(
    codes: Dataset,
    data: Dataset,
    rlen: int,
    alpha: float,
    alpha_type: str = ALPHA_LINEAR,
    random_order: bool = False,
    rng: Optional[CRandom] = None,
    mode: str = "parity",
    snapshot=None,
    progress=None,
    buffer: int = 0,
) -> Dataset:
    """lvq1: move the 1-NN winner toward (label match) or away
    (lvq1_training, lvq_rout.c:498-577).  `snapshot`: interval hook
    (lvq_rout.c:559-567).  `data` may be a data.streaming.StreamingReader
    for bounded-memory training over huge files (parity mode; order
    identical to the full-load buffered path)."""
    talpha = alpha_schedule(rlen, alpha, alpha_type)
    if hasattr(data, "_chunks_one_lap"):  # StreamingReader
        def body(pts, clabels, le, chunk, s, dlab):
            x = chunk.points[s]
            xm = chunk.mask[s] if chunk.mask is not None else None
            w, _ = exact.find_winner_euc(x, pts, xm)
            a = talpha[le] if clabels[w] == dlab[s] else F32(-talpha[le])
            pts[w] = exact.adapt_vector(pts[w], x, a, xm)

        return _lvq_train_streamed(codes, data, rlen, random_order, rng,
                                   mode, body, snapshot, progress)
    order = _train_setup(codes, data, rlen, random_order, rng, buffer)
    if mode == "fast":
        return _lvq1_fast(codes, data, order, talpha)
    pts = codes.points.copy()
    clabels = codes.first_labels().copy()
    dlabels = data.first_labels()
    for le in range(rlen):
        if progress is not None:  # mprint hook (lvq_rout.c:570-571)
            progress(rlen - le)
        s = int(order[le])
        x = data.points[s]
        xm = data.mask[s] if data.mask is not None else None
        w, _ = exact.find_winner_euc(x, pts, xm)
        a = talpha[le] if clabels[w] == dlabels[s] else F32(-talpha[le])
        pts[w] = exact.adapt_vector(pts[w], x, a, xm)
        _maybe_snapshot(snapshot, le, codes, pts)
    if progress is not None:
        progress(0)
    return replace(codes, points=pts, comments=[])


def _lvq_train_streamed(codes, reader, rlen, random_order, rng, mode,
                        body, snapshot, progress):
    """Shared bounded-memory parity driver for the LVQ trainers over a
    StreamingReader (reference: training loops lvq_rout.c:498-916 over
    LOADMODE_BUFFER refills, datafile.c:237-344).  `body(pts, clabels,
    le, chunk, s)` mutates pts in place for one sample; sample order is
    index-identical to sample_order(..., buffer=B), so results are
    bit-equal to the full-load path."""
    if mode != "parity":
        raise ValueError(
            "streamed LVQ training is the bounded-memory parity path; "
            "for fast device training use LVQTrainer over chunk streams")
    if codes.dim != reader.dim:
        raise ValueError("data and codebook dimensions differ")
    from ..data.streaming import streamed_samples

    pts = codes.points.copy()
    clabels = codes.first_labels().copy()
    le = 0
    cur = None
    dlab = None
    for chunk, s in streamed_samples(reader, rlen, random_order, rng):
        if chunk is not cur:  # per-refill label gather, not per-sample
            cur = chunk
            dlab = chunk.first_labels()
        if progress is not None:
            progress(rlen - le)
        body(pts, clabels, le, chunk, s, dlab)
        _maybe_snapshot(snapshot, le, codes, pts)
        le += 1
    if progress is not None:
        progress(0)
    return replace(codes, points=pts, comments=[])


def olvq1_train(
    codes: Dataset,
    data: Dataset,
    rlen: int,
    alpha: float = 0.0,
    init_alphas: Optional[np.ndarray] = None,
    random_order: bool = False,
    rng: Optional[CRandom] = None,
    mode: str = "parity",
    return_alphas: bool = False,
    n_active: Optional[int] = None,
    snapshot=None,
    progress=None,
    buffer: int = 0,
):
    """olvq1: per-code adaptive learning rates — correct winner
    α←α/(1+α), wrong winner α←α/(1−α) clipped at the initial α
    (olvq1_training, lvq_rout.c:584-697).

    alpha==0 uses `init_alphas` (the .lra sidecar) or the default 0.3.

    `n_active`: codes at index >= n_active still compete in the winner
    search but are never adapted.  This replicates the reference balance
    bug: its stale num_entries sizes the alpha array short, so appended
    codes read heap garbage (zero/denormal) as their learning rate and
    are effectively frozen (balance.c:187, lvq_rout.c:614).
    """
    streamed = hasattr(data, "_chunks_one_lap")  # StreamingReader
    if not streamed:
        order = _train_setup(codes, data, rlen, random_order, rng, buffer)
    if alpha == 0.0:
        if init_alphas is not None:
            # NOTE reference quirk (lvq_rout.c:666-672): when resuming
            # from a .lra file with alpha=0, the wrong-classification
            # clip `if (talpha > alpha) talpha = alpha` compares against
            # 0.0 — any wrongly-classifying winner has its learning rate
            # zeroed.  The lvqexample golden depends on this behavior.
            talpha = np.asarray(init_alphas, dtype=F32).copy()
            clip = F32(0.0)
        else:
            talpha = np.full(codes.n, 0.3, dtype=F32)
            clip = F32(0.3)
    else:
        talpha = np.full(codes.n, alpha, dtype=F32)
        clip = F32(alpha)
    if n_active is None:
        n_active = codes.n
    if streamed:
        def body(pts, clabels, le, chunk, s, dlab):
            x = chunk.points[s]
            xm = chunk.mask[s] if chunk.mask is not None else None
            w, _ = exact.find_winner_euc(x, pts, xm)
            if w >= n_active:
                return
            a = talpha[w]
            if clabels[w] == dlab[s]:
                pts[w] = exact.adapt_vector(pts[w], x, a, xm)
                talpha[w] = F32(a / F32(1.0 + a))
            else:
                pts[w] = exact.adapt_vector(pts[w], x, F32(-a), xm)
                na = F32(a / F32(1.0 - a))
                talpha[w] = min(na, clip)

        out = _lvq_train_streamed(codes, data, rlen, random_order, rng,
                                  mode, body, snapshot, progress)
        if return_alphas:
            return out, talpha
        return out
    if mode == "fast":
        out, talpha = _olvq1_fast(codes, data, order, talpha, clip, n_active)
    else:
        pts = codes.points.copy()
        clabels = codes.first_labels()
        dlabels = data.first_labels()
        for le in range(order.shape[0]):
            if progress is not None:  # mprint hook (lvq_rout.c:676-680)
                progress(order.shape[0] - le)
            s = int(order[le])
            x = data.points[s]
            xm = data.mask[s] if data.mask is not None else None
            w, _ = exact.find_winner_euc(x, pts, xm)
            if w >= n_active:
                continue
            a = talpha[w]
            if clabels[w] == dlabels[s]:
                pts[w] = exact.adapt_vector(pts[w], x, a, xm)
                talpha[w] = F32(a / F32(1.0 + a))
            else:
                pts[w] = exact.adapt_vector(pts[w], x, F32(-a), xm)
                na = F32(a / F32(1.0 - a))
                talpha[w] = min(na, clip)
            _maybe_snapshot(snapshot, le, codes, pts)
        if progress is not None:
            progress(0)
        out = replace(codes, points=pts, comments=[])
    if return_alphas:
        return out, talpha
    return out


def _lvq23_train(
    codes: Dataset,
    data: Dataset,
    rlen: int,
    alpha: float,
    winlen: float,
    epsilon: Optional[float],
    alpha_type: str,
    random_order: bool,
    rng: Optional[CRandom],
    snapshot=None,
    progress=None,
    buffer: int = 0,
    mode: str = "parity",
) -> Dataset:
    """Shared lvq2.1/lvq3 loop (lvq_rout.c:702-916). epsilon=None → lvq2."""
    talpha = alpha_schedule(rlen, alpha, alpha_type)
    # C: (1-winlen)/(1+winlen) in float
    wl = F32(F32(1.0 - F32(winlen)) / F32(1.0 + F32(winlen)))
    if hasattr(data, "_chunks_one_lap"):  # StreamingReader
        def body(pts, clabels, le, chunk, s, dlab):
            x = chunk.points[s]
            xm = chunk.mask[s] if chunk.mask is not None else None
            win_idx, win_d = exact.find_winner_knn(x, pts, 2, xm)
            b, nb = int(win_idx[0]), int(win_idx[1])
            ds_, nds = F32(win_d[0]), F32(win_d[1])
            lab, nlab, dlab_s = clabels[b], clabels[nb], dlab[s]
            a = talpha[le]
            if lab != nlab:
                if lab == dlab_s or nlab == dlab_s:
                    if F32(ds_ / nds) > wl:
                        if nlab == dlab_s:
                            b, nb = nb, b
                        pts[b] = exact.adapt_vector(pts[b], x, a, xm)
                        pts[nb] = exact.adapt_vector(pts[nb], x, F32(-a), xm)
            elif epsilon is not None:
                if lab == dlab_s:
                    ae = F32(a * F32(epsilon))
                    pts[b] = exact.adapt_vector(pts[b], x, ae, xm)
                    pts[nb] = exact.adapt_vector(pts[nb], x, ae, xm)

        return _lvq_train_streamed(codes, data, rlen, random_order, rng,
                                   mode, body, snapshot, progress)
    order = _train_setup(codes, data, rlen, random_order, rng, buffer)
    if mode == "fast":
        return _lvq23_fast(codes, data, order, talpha, winlen, epsilon)
    if mode != "parity":
        raise ValueError(f"unknown mode {mode!r} (parity|fast)")
    pts = codes.points.copy()
    clabels = codes.first_labels()
    dlabels = data.first_labels()
    for le in range(rlen):
        if progress is not None:
            progress(rlen - le)
        s = int(order[le])
        x = data.points[s]
        xm = data.mask[s] if data.mask is not None else None
        win_idx, win_d = exact.find_winner_knn(x, pts, 2, xm)
        b, nb = int(win_idx[0]), int(win_idx[1])
        ds_, nds = F32(win_d[0]), F32(win_d[1])
        lab, nlab, dlab = clabels[b], clabels[nb], dlabels[s]
        a = talpha[le]
        if lab != nlab:
            if lab == dlab or nlab == dlab:
                if F32(ds_ / nds) > wl:
                    if nlab == dlab:
                        b, nb = nb, b
                    pts[b] = exact.adapt_vector(pts[b], x, a, xm)
                    pts[nb] = exact.adapt_vector(pts[nb], x, F32(-a), xm)
        elif epsilon is not None:
            if lab == dlab:
                ae = F32(a * F32(epsilon))
                pts[b] = exact.adapt_vector(pts[b], x, ae, xm)
                pts[nb] = exact.adapt_vector(pts[nb], x, ae, xm)
        _maybe_snapshot(snapshot, le, codes, pts)
    if progress is not None:
        progress(0)
    return replace(codes, points=pts, comments=[])


def _maybe_snapshot(snapshot, le, codes_meta, pts):
    """Interval snapshot hook shared by the LVQ trainers
    (lvq_rout.c:559-567, :676-684)."""
    if snapshot is not None and le > 0 and (le % snapshot.interval) == 0:
        snapshot(le, replace(codes_meta, points=pts.copy(), comments=[]))


def lvq2_train(codes, data, rlen, alpha, winlen, alpha_type=ALPHA_LINEAR,
               random_order=False, rng=None, mode="parity", snapshot=None,
               progress=None, buffer=0):
    """lvq2.1 window-rule training (lvq_rout.c:702-803).  mode='fast'
    runs the jitted device scan (_lvq23_fast); 'parity' is bit-exact."""
    return _lvq23_train(codes, data, rlen, alpha, winlen, None, alpha_type,
                        random_order, rng, snapshot, progress, buffer, mode)


def lvq3_train(codes, data, rlen, alpha, winlen, epsilon,
               alpha_type=ALPHA_LINEAR, random_order=False, rng=None,
               mode="parity", snapshot=None, progress=None, buffer=0):
    """lvq3 training: lvq2.1 rule + same-class epsilon pull
    (lvq_rout.c:808-916).  mode='fast' runs the jitted device scan."""
    return _lvq23_train(codes, data, rlen, alpha, winlen, epsilon, alpha_type,
                        random_order, rng, snapshot, progress, buffer, mode)


# ---------------------------------------------------------------------------
# Trainers — fast path (jitted scan, matmul winner search)
# ---------------------------------------------------------------------------

def _lvq1_fast(codes: Dataset, data: Dataset, order, talpha) -> Dataset:
    import jax
    import jax.numpy as jnp

    from ..ops.distance import sq_distances

    X = jnp.asarray(data.points)
    M = None if data.mask is None else jnp.asarray(data.mask)
    dlab = jnp.asarray(data.first_labels())
    clab = jnp.asarray(codes.first_labels())

    def step(pts, inp):
        s, a = inp
        x = X[s][None, :]
        xm = None if M is None else M[s][None, :]
        d = sq_distances(x, pts, xm)[0]
        w = jnp.argmin(d)
        sign = jnp.where(clab[w] == dlab[s], a, -a)
        delta = sign * (x[0] - pts[w])
        if xm is not None:
            delta = jnp.where(xm[0] != 0, 0.0, delta)
        return pts.at[w].add(delta), None

    final, _ = jax.jit(lambda c: jax.lax.scan(step, c, (jnp.asarray(order), jnp.asarray(talpha))))(
        jnp.asarray(codes.points)
    )
    return replace(codes, points=np.asarray(final), comments=[])


def _lvq23_fast(codes: Dataset, data: Dataset, order, talpha,
                winlen: float, epsilon: Optional[float]) -> Dataset:
    """Jitted sequential lvq2.1/lvq3 scan: per-sample top-2 winner on
    the device, window predicate d1/d2 > (1-w)/(1+w), exclusive
    window-pair / same-class-epsilon updates (lvq_rout.c:702-916).
    Sequential-sample semantics preserved (one sample per scan step);
    differs from parity only in accumulation order/precision."""
    import jax
    import jax.numpy as jnp

    from ..ops.distance import sq_distances

    X = jnp.asarray(data.points)
    M = None if data.mask is None else jnp.asarray(data.mask)
    dlab = jnp.asarray(data.first_labels())
    clab = jnp.asarray(codes.first_labels())
    wl = jnp.float32(F32(F32(1.0 - F32(winlen)) / F32(1.0 + F32(winlen))))
    lvq3 = epsilon is not None
    eps = jnp.float32(epsilon if lvq3 else 0.0)

    def step(pts, inp):
        s, a = inp
        x = X[s][None, :]
        xm = None if M is None else M[s][None, :]
        d = sq_distances(x, pts, xm)[0]
        negd, idx = jax.lax.top_k(-d, 2)
        b, nb = idx[0], idx[1]
        ds_, nds = -negd[0], -negd[1]
        lab, nlab, dl = clab[b], clab[nb], dlab[s]
        in_win = jnp.where(nds > 0, ds_ / jnp.where(nds > 0, nds, 1.0),
                           jnp.inf) > wl
        window_rule = (lab != nlab) & ((lab == dl) | (nlab == dl)) & in_win
        swap = nlab == dl
        b2 = jnp.where(swap, nb, b)
        nb2 = jnp.where(swap, b, nb)
        ab = jnp.where(window_rule, a, 0.0)
        keep = 1.0 if xm is None else (1.0 - xm[0].astype(jnp.float32))
        d_b = ab * keep * (x[0] - pts[b2])
        d_nb = -ab * keep * (x[0] - pts[nb2])
        if lvq3:
            # exclusive with the window branch (lab == nlab there), so
            # deltas computed from the pre-update rows are exact
            same = (lab == nlab) & (lab == dl)
            ae = jnp.where(same, a * eps, 0.0)
            d_e1 = ae * keep * (x[0] - pts[b])
            d_e2 = ae * keep * (x[0] - pts[nb])
            pts = (pts.at[b2].add(d_b).at[nb2].add(d_nb)
                   .at[b].add(d_e1).at[nb].add(d_e2))
        else:
            pts = pts.at[b2].add(d_b).at[nb2].add(d_nb)
        return pts, None

    final, _ = jax.jit(
        lambda c: jax.lax.scan(step, c, (jnp.asarray(order), jnp.asarray(talpha)))
    )(jnp.asarray(codes.points))
    return replace(codes, points=np.asarray(final), comments=[])


def _olvq1_fast(codes: Dataset, data: Dataset, order, talpha0, clip, n_active):
    import jax
    import jax.numpy as jnp

    from ..ops.distance import sq_distances

    X = jnp.asarray(data.points)
    M = None if data.mask is None else jnp.asarray(data.mask)
    dlab = jnp.asarray(data.first_labels())
    clab = jnp.asarray(codes.first_labels())

    def step(carry, s):
        pts, al = carry
        x = X[s][None, :]
        xm = None if M is None else M[s][None, :]
        d = sq_distances(x, pts, xm)[0]
        w = jnp.argmin(d)
        a = al[w]
        correct = clab[w] == dlab[s]
        sign = jnp.where(correct, a, -a)
        delta = sign * (x[0] - pts[w])
        if xm is not None:
            delta = jnp.where(xm[0] != 0, 0.0, delta)
        new_a = jnp.where(correct, a / (1.0 + a), jnp.minimum(a / (1.0 - a), clip))
        active = w < n_active
        delta = jnp.where(active, delta, 0.0)
        new_a = jnp.where(active, new_a, a)
        return (pts.at[w].add(delta), al.at[w].set(new_a)), None

    (final, alphas), _ = jax.jit(
        lambda c, a: jax.lax.scan(step, (c, a), jnp.asarray(order))
    )(jnp.asarray(codes.points), jnp.asarray(talpha0))
    return replace(codes, points=np.asarray(final), comments=[]), np.asarray(alphas)
