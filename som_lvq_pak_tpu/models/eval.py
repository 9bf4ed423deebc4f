"""Evaluation tools: accuracy, classify, knntest, cmatr, mcnemar.

Reference behavior: accuracy.c:39-137, classify.c:41-95,
knntest.c:41-157, cmatr.c:41-170, mcnemar.c:43-132.  Report strings are
byte-compatible with the C tools (the golden tests diff them).

The per-sample scalar winner scans become one batched distance
computation; per-class tallies keep the reference's hitlist ordering
(frequency-descending, ties by first-to-reach) for identical reports.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Tuple

import numpy as np

from ..data.dataset import Dataset
from ..data.labels import GLOBAL_LABELS, LabelTable
from ..ops import exact
from ..utils.hitlist import Hitlist, majority_label_matrix


def _winner_labels(data: Dataset, codes: Dataset, parity: bool = True) -> np.ndarray:
    """(N,) first-label of each sample's 1-NN code (ties → first index)."""
    if parity:
        d = exact.pairwise_sq_distances(data.points, codes.points, data.mask)
        idx = d.argmin(axis=1)
    else:
        import jax.numpy as jnp

        from ..ops.dispatch import find_bmu

        idx, _ = find_bmu(
            jnp.asarray(data.points),
            jnp.asarray(codes.points),
            None if data.mask is None else jnp.asarray(data.mask),
        )
        idx = np.asarray(idx)
    return codes.first_labels()[idx]


def accuracy(
    data: Dataset,
    codes: Dataset,
    labels: Optional[LabelTable] = None,
    parity: bool = True,
) -> Tuple[float, str, np.ndarray]:
    """1-NN recognition accuracy (compute_accuracy, accuracy.c:39-137).

    Returns (total_percent, report_text, per_sample_correct uint8) —
    the last is the -cfout stream ('1'/'0' per sample).

    `data` may be a data.streaming.StreamingReader: evaluation then runs
    chunk-by-chunk with bounded memory (the reference's buffered eval,
    accuracy.c over LOADMODE_BUFFER), identical tallies and report."""
    table = labels if labels is not None else GLOBAL_LABELS
    if hasattr(data, "_chunks_one_lap"):  # StreamingReader
        parts_lab: List[np.ndarray] = []
        parts_ok: List[np.ndarray] = []
        for chunk in data.chunks(laps=1):
            cl = chunk.first_labels()
            wl = _winner_labels(chunk, codes, parity)
            parts_lab.append(cl)
            parts_ok.append((wl == cl).astype(np.uint8))
        dlabels = (np.concatenate(parts_lab) if parts_lab
                   else np.zeros((0,), np.int32))
        ok = (np.concatenate(parts_ok) if parts_ok
              else np.zeros((0,), np.uint8))
        total = int(dlabels.shape[0])
    else:
        dlabels = data.first_labels()
        wlabels = _winner_labels(data, codes, parity)
        ok = (wlabels == dlabels).astype(np.uint8)
        total = data.n

    correct, totals = Hitlist(), Hitlist()
    for lab, o in zip(dlabels.tolist(), ok.tolist()):
        if o:
            correct.add_hit(lab)
        totals.add_hit(lab)
    stotal = int(ok.sum())

    lines = ["", "Recognition accuracy:", ""]
    for lab, tot in totals.items():
        res = correct.label_freq(lab)
        lines.append(
            "%9s: %4d entries %6.2f %%"
            % (table.to_label(lab), tot, 100.0 * np.float32(res) / tot)
        )
    lines.append("")
    lines.append(
        "Total accuracy: %5d entries %6.2f %%" % (total, 100.0 * np.float32(stotal) / total)
    )
    lines.append("")
    pct = 100.0 * stotal / total
    return pct, "\n".join(lines) + "\n", ok


def classify(
    data: Dataset, codes: Dataset, labels: Optional[LabelTable] = None, parity: bool = True
) -> Tuple[Dataset, List[str]]:
    """Label every sample with its 1-NN code label
    (compute_classifications, classify.c:41-95).  Returns the relabeled
    dataset and the -cfout label strings."""
    table = labels if labels is not None else GLOBAL_LABELS
    wlabels = _winner_labels(data, codes, parity).astype(np.int32)
    if data.mask is not None:
        empty = data.mask.all(axis=1)
        if empty.any():
            eid = table.to_index("# empty datavector")
            wlabels = np.where(empty, eid, wlabels)
    out = replace(data, labels=wlabels[:, None].copy(), comments=[])
    names = [table.to_label(int(l)) or "" for l in wlabels]
    return out, names


def knn_accuracy(
    data: Dataset,
    codes: Dataset,
    knn: int = 5,
    labels: Optional[LabelTable] = None,
    mode: str = "parity",
) -> Tuple[float, str]:
    """k-NN majority-vote accuracy (compute_knnaccuracy, knntest.c:41-157).
    mode='parity' = exact C accumulation order at every size; 'fast' =
    device dist-matmul path for huge data (same tie order)."""
    table = labels if labels is not None else GLOBAL_LABELS
    if knn < 1:
        knn = 1

    def votes_ok(block: Dataset):
        from ..ops.distance import pairwise_topk_mode

        idx, _ = pairwise_topk_mode(block.points, codes.points, knn,
                                    block.mask, mode=mode)
        clabels = codes.first_labels()
        neigh = clabels[idx]
        num = int(max(clabels.max(initial=0),
                      block.first_labels().max(initial=0))) + 1
        votes = majority_label_matrix(neigh, num)
        dl = block.first_labels()
        return dl, votes == dl

    if hasattr(data, "_chunks_one_lap"):  # StreamingReader (bounded RSS)
        parts = [votes_ok(c) for c in data.chunks(laps=1)]
        dlabels = (np.concatenate([p[0] for p in parts]) if parts
                   else np.zeros((0,), np.int32))
        ok = (np.concatenate([p[1] for p in parts]) if parts
              else np.zeros((0,), bool))
        total = int(dlabels.shape[0])
    else:
        dlabels, ok = votes_ok(data)
        total = data.n

    correct, totals = Hitlist(), Hitlist()
    for lab, o in zip(dlabels.tolist(), ok.tolist()):
        if o:
            correct.add_hit(lab)
        totals.add_hit(lab)
    stotal = int(ok.sum())

    lines = ["", "Recognition accuracy:", ""]
    for lab, tot in totals.items():
        res = correct.label_freq(lab)
        lines.append(
            "%14s: %6.2f %%" % (table.to_label(lab), 100.0 * np.float32(res) / tot)
        )
    lines.append("")
    lines.append("Total accuracy: %6.2f %%" % (100.0 * np.float32(stotal) / total))
    lines.append("")
    return 100.0 * stotal / total, "\n".join(lines) + "\n"


def confusion_matrix(
    data: Dataset,
    codes: Dataset,
    labels: Optional[LabelTable] = None,
    parity: bool = True,
) -> Tuple[str, np.ndarray, np.ndarray]:
    """Confusion matrix by the 1-NN rule (compute_cmatr, cmatr.c:41-170).
    Pairs are tallied as datalabel*65536+label like the reference.
    Returns (report, matrix, per_sample_correct) — the last is the
    -cfout 0/1 stream over the valid (not all-masked) samples
    (cmatr.c:96-106)."""
    table = labels if labels is not None else GLOBAL_LABELS
    correct, totals, confusion = Hitlist(), Hitlist(), Hitlist()
    stotal = total = 0
    ok: List[int] = []

    def tally(block: Dataset):
        nonlocal stotal, total
        dlabels = block.first_labels()
        wlabels = _winner_labels(block, codes, parity)
        if block.mask is not None:
            valid = ~block.mask.all(axis=1)
        else:
            valid = np.ones(block.n, dtype=bool)
        for dl, wl, v in zip(dlabels.tolist(), wlabels.tolist(),
                             valid.tolist()):
            if not v:
                continue
            if dl == wl:
                stotal += 1
                correct.add_hit(dl)
                ok.append(1)
            else:
                ok.append(0)
            confusion.add_hit(dl * 65536 + wl)
            totals.add_hit(dl)
            total += 1

    if hasattr(data, "_chunks_one_lap"):  # StreamingReader (bounded RSS)
        for chunk in data.chunks(laps=1):
            tally(chunk)
    else:
        tally(data)

    lines = ["", "Recognition accuracy:", ""]
    for lab, tot in totals.items():
        res = correct.label_freq(lab)
        lines.append(
            "%9s: %4d entries %6.2f %%"
            % (table.to_label(lab), tot, 100.0 * np.float32(res) / tot)
        )
    lines.append("")
    lines.append(
        "Total accuracy: %5d entries %6.2f %%" % (total, 100.0 * np.float32(stotal) / total)
    )
    lines.append("")
    lines.append("Confusion matrix:")
    lines.append("")
    hdr = "          "
    for lab, _ in totals.items():
        hdr += " %4s" % table.to_label(lab)
    lines.append(hdr)
    lines.append("")
    order = [lab for lab, _ in totals.items()]
    mat = np.zeros((len(order), len(order)), dtype=np.int64)
    for i, li in enumerate(order):
        row = "%9s: " % table.to_label(li)
        for j, lj in enumerate(order):
            c = confusion.label_freq(li * 65536 + lj)
            mat[i, j] = c
            row += "%4d " % c
        lines.append(row)
    lines.append("")
    return "\n".join(lines) + "\n", mat, np.asarray(ok, dtype=np.uint8)


MCNEMAR_ALPHA = (0.05, 0.025, 0.01, 0.005)
MCNEMAR_CHI_SQ = (3.84, 5.02, 6.63, 7.88)


def mcnemar(c1: np.ndarray, c2: np.ndarray) -> str:
    """McNemar chi^2 significance between two 0/1 classification streams
    (mcnemar.c:43-132). Returns the report text."""
    c1 = np.asarray(c1, dtype=np.int64)
    c2 = np.asarray(c2, dtype=np.int64)
    if c1.shape != c2.shape:
        raise ValueError("Unequal numbers of classifications in files.")
    if not (np.isin(c1, (0, 1)).all() and np.isin(c2, (0, 1)).all()):
        raise ValueError("Files contain other than 0's and 1's.")
    tbl = np.zeros((2, 2), dtype=np.int64)
    for a, b in zip(1 - c1, 1 - c2):
        tbl[a, b] += 1
    cnt = tbl[0, 1] + tbl[1, 0]
    lines = []
    if cnt:
        lines.append("")
        lines.append("Statistics of the results of the two classifiers:")
        lines.append("             1st correct,  1st errors")
        lines.append("2nd correct:      %6d       %6d" % (tbl[0, 0], tbl[1, 0]))
        lines.append("2nd errors:       %6d       %6d" % (tbl[0, 1], tbl[1, 1]))
        tmp = float(tbl[0, 1] - tbl[1, 0])
        testv = tmp * tmp / cnt
        sig = -1
        for i in range(3, -1, -1):
            if testv > MCNEMAR_CHI_SQ[i]:
                sig = i
                break
        lines.append("")
        if sig >= 0:
            lines.append(
                "Test statistics (%.3f) is significant at risk level %.3f"
                % (testv, MCNEMAR_ALPHA[sig])
            )
            lines.append("The classifiers are significantly different!")
        else:
            lines.append("Test statistics (%.3f) is not significant!" % testv)
            lines.append("The classifiers are not significantly different!")
    else:
        lines.append("")
        lines.append("Recognition result files are equal!")
    return "\n".join(lines) + "\n"
