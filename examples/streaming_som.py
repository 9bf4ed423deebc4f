"""BASELINE config 5, single-chip portion: train a SOM on 1 M vectors
streamed from disk through the buffered input pipeline.

The reference handles files bigger than RAM with LOADMODE_BUFFER
(datafile.c:237-344): refill a linked-list buffer inside next_entry,
rewind per lap.  Here the same contract is data.streaming.StreamingReader
(background parse/prefetch thread, native C++ line parser) feeding
SOMTrainer, which ships chunks to the device in superblocks ahead of
compute and runs the minibatch training step on the device.

Run:
    python examples/streaming_som.py                     # 1M x 64, 128x128 map
    python examples/streaming_som.py --n 50000 --map 32  # smoke run

Prints a JSON summary: end-to-end samples/s (parse + H2D + train), the
qerror before/after on a held-out subsample, and wall times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def generate_file(path: str, n: int, dim: int, n_clusters: int = 64,
                  seed: int = 7, chunk: int = 50_000) -> float:
    """Write an n x dim data file in the package text format."""
    t0 = time.time()
    r = np.random.RandomState(seed)
    centers = r.uniform(-4.0, 4.0, size=(n_clusters, dim)).astype(np.float32)
    with open(path, "w") as f:
        f.write(f"{dim}\n")
        done = 0
        while done < n:
            m = min(chunk, n - done)
            asg = r.randint(0, n_clusters, size=m)
            pts = centers[asg] + r.normal(0, 0.5, size=(m, dim)).astype(np.float32)
            np.savetxt(f, pts, fmt="%.4f")
            done += m
    return time.time() - t0


def run_streaming_som(path: str, n: int, dim: int, side: int, batch: int,
                      buffer: int = 16384, laps: int = 0) -> dict:
    from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
    from som_lvq_pak_tpu.data.streaming import StreamingReader
    from som_lvq_pak_tpu.models.som import find_qerror, randinit
    from som_lvq_pak_tpu.models.trainer import SOMTrainer
    from som_lvq_pak_tpu.utils.rng import CRandom

    gen_s = 0.0
    if not os.path.exists(path):
        gen_s = generate_file(path, n, dim)

    # init from the first buffer's worth of data (enough for min/max box)
    sr = StreamingReader(path, buffer=buffer)
    head = next(iter(sr.chunks(laps=1)))
    rng = CRandom()
    rng.init_random(123)
    codes = randinit(head, topol=Topology.HEXA, neigh=Neighborhood.GAUSSIAN,
                     xdim=side, ydim=side, rng=rng)
    q0 = find_qerror(codes, head, mode="fast") / head.n

    rlen = n * max(1, laps)
    tr = SOMTrainer(codes, batch_size=batch, update="mean")
    t0 = time.time()
    codes = tr.fit(
        StreamingReader(path, buffer=buffer).chunks(laps=None),
        rlen=rlen, alpha=0.05, radius=side / 2.0,
    )
    wall = time.time() - t0
    q1 = find_qerror(codes, head, mode="fast") / head.n

    return {
        "n": n, "dim": dim, "map": [side, side], "rlen": rlen,
        "file_mb": round(os.path.getsize(path) / 1e6, 1),
        "gen_wall_s": round(gen_s, 1),
        "train_wall_s": round(wall, 2),
        "samples_per_s": round(rlen / wall),
        "qerror_subsample": [round(float(q0), 4), round(float(q1), 4)],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--map", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--buffer", type=int, default=16384)
    ap.add_argument("--laps", type=int, default=1)
    ap.add_argument("--file", default="")
    args = ap.parse_args()

    path = args.file or os.path.join(
        os.environ.get("TMPDIR", "/tmp"),
        f"stream_som_{args.n}x{args.dim}.dat")
    summary = run_streaming_som(path, args.n, args.dim, args.map,
                                args.batch, args.buffer, args.laps)
    print(json.dumps(summary))
    assert summary["qerror_subsample"][1] < summary["qerror_subsample"][0], \
        "streamed training must reduce quantization error"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
