"""Time the Triton winner kernel against the plain XLA winner search on
the GPU, check it against the float32 reference, and time the XLA
update op.

    python tools/kernel_bench.py [--shapes 4096x65536x64,1024x65536x64]
                                 [--sweep] [--lap [--lap-pairs N]]
                                 [--out rows.json]

Each timing is the median over 5 windows of 20 back-to-back calls, after
a warm-up call, ending in block_until_ready.  --sweep also times a few
block configurations of the kernel.  --lap times one SOMTrainer lap of
the north-star deployment (256x256 hexa gaussian map, 2^20 x 64 samples
streamed in 16,384-sample chunks, B=4096) with each winner op, in
--lap-pairs pairs that alternate which runs first.  Needs a GPU;
refuses to run on another backend.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from som_lvq_pak_tpu.ops import dispatch, triton_winner  # noqa: E402
from som_lvq_pak_tpu.ops.distance import find_winners, topk_winners  # noqa: E402


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timeit(fn, *args, reps: int = 20, windows: int = 5) -> float:
    """Median seconds per call."""
    jax.block_until_ready(fn(*args))
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / reps)
    return float(np.median(per))


def mixture(rng, n, d, centres=16):
    """The north-star data: a 16-centre gaussian mixture."""
    c = rng.normal(0.0, 4.0, size=(centres, d)).astype(np.float32)
    lab = rng.integers(0, centres, size=n)
    return c[lab] + rng.normal(0.0, 1.0, size=(n, d)).astype(np.float32)


def winner_check(x, codes, idx, k):
    """Share of rows whose winners equal the reference, and the largest
    relative excess of a differing row's exact distance over the exact
    distance of the reference's pick."""
    ridx, _ = topk_winners(x, codes, k)
    ridx = np.asarray(ridx)
    idx = np.asarray(idx)
    same = np.all(idx == ridx, axis=1)
    xs, cs = np.asarray(x, np.float64), np.asarray(codes, np.float64)
    worst = 0.0
    for r in np.nonzero(~same)[0]:
        got = ((xs[r] - cs[idx[r]]) ** 2).sum(axis=1)
        ref = ((xs[r] - cs[ridx[r]]) ** 2).sum(axis=1)
        worst = max(worst, float(np.max((got - ref) / np.maximum(ref, 1e-30))))
    return float(same.mean()), worst


def lap_compare(name, seed, pairs, n=1 << 20, bs=4096, chunk=16384):
    """Wall seconds of one SOMTrainer lap with each winner op, `pairs`
    times, alternating which runs first (triton, xla, xla, triton, ...),
    and the fast qerror of each map."""
    from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
    from som_lvq_pak_tpu.models.som import find_qerror, randinit
    from som_lvq_pak_tpu.models.trainer import SOMTrainer
    from som_lvq_pak_tpu.utils.rng import CRandom

    X = mixture(np.random.default_rng(seed), n, 64)
    crng = CRandom()
    crng.init_random(123)
    codes = randinit(Dataset(points=X), topol=Topology.HEXA,
                     neigh=Neighborhood.GAUSSIAN, xdim=256, ydim=256, rng=crng)
    data_dev = Dataset(points=jnp.asarray(X))

    def stream(total):
        for s in range(0, total, chunk):
            yield Dataset(points=X[s % n:s % n + chunk])

    winner0 = dispatch.winner_impl
    rows = []
    order = [w for i in range(pairs)
             for w in (("triton", "xla") if i % 2 == 0 else ("xla", "triton"))]
    for rep, w in enumerate(order):
        dispatch.winner_impl = lambda *a, _w=w, **k: _w
        jax.clear_caches()
        SOMTrainer(codes, batch_size=bs).fit(
            stream(2 * bs), rlen=2 * bs, alpha=0.05, radius=64)
        t0 = time.perf_counter()
        out = SOMTrainer(codes, batch_size=bs).fit(
            stream(n), rlen=n, alpha=0.05, radius=64)
        t_lap = time.perf_counter() - t0
        q = find_qerror(out, data_dev, mode="fast") / n
        rec = dict(op="lap", winner=w, rep=rep, lap_s=t_lap, qerror=q,
                   card=name)
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    dispatch.winner_impl = winner0
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="4096x65536x64,1024x65536x64")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--lap", action="store_true")
    ap.add_argument("--lap-pairs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write every row to this JSON file")
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"kernel_bench: needs a GPU, found {dev.platform}", file=sys.stderr)
        return 1
    name = card()
    rows = []
    rng = np.random.default_rng(args.seed)
    for spec in args.shapes.split(","):
        B, N, D = (int(v) for v in spec.split("x"))
        side = int(round(N ** 0.5))
        xdim = side if side * side == N else N
        data = mixture(rng, B + N, D)
        x = jnp.asarray(data[:B])
        lo, hi = data.min(axis=0), data.max(axis=0)
        codes = jnp.asarray(
            (lo + (hi - lo) * rng.random((N, D))).astype(np.float32))
        a = jnp.full((B,), 0.05, jnp.float32)
        r = jnp.float32(max(1.0, xdim / 4))

        def row(op, impl, secs, **kw):
            rec = dict(op=op, impl=impl, B=B, N=N, D=D, ms=secs * 1e3,
                       card=name, **kw)
            rows.append(rec)
            print(json.dumps(rec), flush=True)

        xla1 = jax.jit(lambda x, c: find_winners(x, c)[0])
        xla1_tf32 = jax.jit(lambda x, c: find_winners(x, c, precision=None)[0])
        row("winner", "xla_highest", timeit(xla1, x, codes))
        row("winner", "xla_default", timeit(xla1_tf32, x, codes))
        cfgs = [(128, 64, 8, 2)]
        if args.sweep:
            cfgs += [(128, 128, 8, 2), (256, 64, 8, 2), (128, 64, 8, 3)]
        for k in (1, 2):
            if k == 2:
                xla2 = jax.jit(lambda x, c: topk_winners(x, c, 2)[0])
                row("top2", "xla_highest", timeit(xla2, x, codes))
            for bb, bn, nw, ns in cfgs:
                fn = jax.jit(functools.partial(
                    triton_winner.winner_topk, k=k, block_b=bb, block_n=bn,
                    num_warps=nw, num_stages=ns))
                idx, _ = fn(x, codes)
                agree, worst = winner_check(x, codes, idx, k)
                row("winner" if k == 1 else "top2", "triton",
                    timeit(lambda x, c: fn(x, c)[0], x, codes),
                    block=[bb, bn, nw, ns], agree=agree, worst_rel=worst)

        bmu = jnp.asarray(find_winners(x, codes)[0], jnp.int32)
        upd = jax.jit(functools.partial(dispatch.som_update, xdim=xdim,
                                        hexa=True, gaussian=True))
        row("update", "xla_default", timeit(
            lambda c, x, b: upd(c, x, b, a, r), codes, x, bmu),
            nbhd="gaussian-hexa")
    if args.lap:
        rows.extend(lap_compare(name, args.seed, args.lap_pairs))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(json.dumps({"card": name, "rows": len(rows), "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
