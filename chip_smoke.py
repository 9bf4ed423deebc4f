"""Smoke run of somvq's fast SOM and LVQ paths on one GPU, at the widths
of the north-star deployment, each phase checked against the plain
float32 reference.

    python chip_smoke.py [--seed 0]          # phases O, A, B, C on one card
    python chip_smoke.py --four-cards        # phase D only, on four cards

Phases (one process, in order):

  O  the winner op (Pallas-Triton on the GPU) and the update op at
     4096 x 65,536 x 64 against the references, as compiled for the card
  A  library: 256x256 hexa gaussian map, randinit, one SOMTrainer lap
     over 2^20 x 64 mixture samples streamed in 16,384-sample chunks
     (B=4096, alpha 0.05, radius 64), then fast qerror over all samples
  B  CLI in-process: randinit, vsom -fast -buffer 16384, qerror -fast on
     a 262,144 x 64 data file
  C  LVQ at lvqexample's widths: eveninit (200 codes, D=20, 10 classes),
     one OLVQ1Trainer pass over 100,000 samples (B=256), accuracy on
     20,000, one lvq3 step
  D  (--four-cards) SOMTrainer on make_mesh(4, 1, 4) and (4, 2, 2) for
     64 steps (qerror against one card), each sharded step against the
     one-card step from the same codebook, and the sharded olvq1 and lvq3
     steps against one card

Every time is printed beside the card's name and power limit.  Any
failed check raises, so the process exits non-zero and prints no result;
the last line of a passing run is one JSON object naming the device.
The script exits non-zero on any backend but the GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

MAP = (256, 256)       # north-star map: 65,536 units
DIM = 64
BATCH = 4096
CHUNK = 16384
ALPHA, RADIUS = 0.05, 64.0


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines() if ln.strip())


def say(phase: str, msg: str, where: str = "") -> None:
    print(f"[{phase}] {msg}" + (f"  | {where}" if where else ""), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def mixture(rng, n: int, d: int, centres: int = 16) -> np.ndarray:
    """The north-star data: a 16-centre gaussian mixture."""
    c = rng.normal(0.0, 4.0, size=(centres, d)).astype(np.float32)
    return (c[rng.integers(0, centres, size=n)]
            + rng.normal(0.0, 1.0, size=(n, d)).astype(np.float32))


@contextlib.contextmanager
def reference_ops():
    """Run the library with its plain reference ops: every winner search
    through XLA at precision="highest" and every f32 product in full f32."""
    import jax

    from som_lvq_pak_tpu.ops import dispatch

    saved = dispatch.winner_impl
    dispatch.winner_impl = lambda *a, **k: "xla"
    jax.clear_caches()
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        dispatch.winner_impl = saved
        jax.clear_caches()


def ref_qerror(codes, data) -> float:
    """Reference qerror per sample: exact-f32 winner and distance."""
    from som_lvq_pak_tpu.models.som import find_qerror

    with reference_ops():
        return find_qerror(codes, data, mode="fast") / data.n


def randinit_map(X, seed: int, xdim: int, ydim: int, gaussian: bool = True):
    from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
    from som_lvq_pak_tpu.models.som import randinit
    from som_lvq_pak_tpu.utils.rng import CRandom

    crng = CRandom()
    crng.init_random(seed + 1)
    return randinit(Dataset(points=X), topol=Topology.HEXA,
                    neigh=Neighborhood.GAUSSIAN if gaussian else Neighborhood.BUBBLE,
                    xdim=xdim, ydim=ydim, rng=crng)


# ---------------------------------------------------------------------------
# phase O: the ops, as compiled for the card, against the references
# ---------------------------------------------------------------------------

def phase_ops(seed: int, where: str, B: int = BATCH, xdim: int = MAP[0],
              ydim: int = MAP[1], d: int = DIM) -> dict:
    import jax
    import jax.numpy as jnp

    from som_lvq_pak_tpu.ops import dispatch
    from som_lvq_pak_tpu.ops.distance import topk_winners

    rng = np.random.default_rng(seed)
    N = xdim * ydim
    X = mixture(rng, B + N, d)
    x = jnp.asarray(X[:B])
    codes = jnp.asarray(randinit_map(X, seed, xdim, ydim).points)
    impl = dispatch.winner_impl(d, False)
    out = {"winner_impl": impl}
    xs = np.asarray(x, np.float64)
    cs = np.asarray(codes, np.float64)
    for k in (1, 2):
        if k == 1:
            fn = jax.jit(lambda x, c: dispatch.find_bmu(x, c)[0][:, None])
        else:
            fn = jax.jit(lambda x, c: dispatch.find_top2(x, c)[0])
        idx = np.asarray(jax.block_until_ready(fn(x, codes)))
        t0 = time.perf_counter()
        for _ in range(10):
            r = fn(x, codes)
        jax.block_until_ready(r)
        ms = (time.perf_counter() - t0) / 10 * 1e3
        ridx = np.asarray(topk_winners(x, codes, k)[0])
        same = np.all(idx == ridx, axis=1)
        worst = 0.0
        for i in np.nonzero(~same)[0]:
            got = ((xs[i] - cs[idx[i]]) ** 2).sum(axis=1)
            ref = ((xs[i] - cs[ridx[i]]) ** 2).sum(axis=1)
            worst = max(worst, float(np.max(np.abs(got - ref) / ref)))
        say("O", f"top{k} ({impl}) {B}x{N}x{d}: {ms:.3f} ms/call, index equal "
            f"on {same.mean():.6f} of rows, worst other-row excess {worst:.2e}",
            where)
        check(same.mean() >= 0.999, f"top{k}: index agreement {same.mean()}")
        check(worst <= 1e-3, f"top{k}: distance excess {worst}")
        out[f"top{k}_agree"] = float(same.mean())

    bmu = jnp.asarray(topk_winners(x, codes, 1)[0][:, 0], jnp.int32)
    a = jnp.full((B,), ALPHA, jnp.float32)
    scale = float(jnp.max(jnp.abs(codes)))
    for gaussian in (False, True):
        for hexa in (True, False):
            def upd(c, x, b, gaussian=gaussian, hexa=hexa):
                return dispatch.som_update(c, x, b, a, RADIUS / 4, xdim=xdim,
                                           hexa=hexa, gaussian=gaussian)
            got = jax.jit(upd)(codes, x, bmu)
            with jax.default_matmul_precision("highest"):
                ref = jax.jit(upd)(codes, x, bmu)
            err = float(jnp.max(jnp.abs(got - ref))) / scale
            tag = f"{'gaussian' if gaussian else 'bubble'}-{'hexa' if hexa else 'rect'}"
            say("O", f"update {tag}: max|delta| = {err:.2e} x max|codebook| "
                "(XLA, default f32 matmul precision)", where)
            # TF32 on the card: the bound for a TF32 product
            check(err <= 1e-3, f"update {tag}: {err}")
            out[f"update_{tag}"] = err
    return out


# ---------------------------------------------------------------------------
# phase A: library, north-star widths
# ---------------------------------------------------------------------------

def phase_a(seed: int, where: str, n: int = 1 << 20, xdim: int = MAP[0],
            ydim: int = MAP[1], d: int = DIM, batch: int = BATCH,
            chunk: int = CHUNK, radius: float = RADIUS) -> dict:
    import jax
    import jax.numpy as jnp

    from som_lvq_pak_tpu.data.dataset import Dataset
    from som_lvq_pak_tpu.models.fast import som_batch_step, unit_coords
    from som_lvq_pak_tpu.models.som import find_qerror
    from som_lvq_pak_tpu.models.trainer import SOMTrainer

    rng = np.random.default_rng(seed)
    X = mixture(rng, n, d)
    codes = randinit_map(X, seed, xdim, ydim)
    data_dev = Dataset(points=jnp.asarray(X))

    def stream(total):
        for s in range(0, total, chunk):
            yield Dataset(points=X[s % n:s % n + chunk])

    def fit(rlen):
        return SOMTrainer(codes, batch_size=batch, seed=seed).fit(
            stream(rlen), rlen=rlen, alpha=ALPHA, radius=radius)

    t0 = time.perf_counter()
    fit(2 * batch)
    q0 = find_qerror(codes, data_dev, mode="fast") / n
    say("A", f"compile (2-step warm fit + eval): {time.perf_counter() - t0:.2f} s",
        where)
    t0 = time.perf_counter()
    trained = fit(n)
    t_lap = time.perf_counter() - t0
    t0 = time.perf_counter()
    q1 = find_qerror(trained, data_dev, mode="fast") / n
    t_eval = time.perf_counter() - t0
    say("A", f"one lap {n} samples, map {xdim}x{ydim}, B={batch}: {t_lap:.3f} s; "
        f"fast qerror over {n}: {t_eval:.3f} s", where)
    say("A", f"qerror per sample: initial {q0:.6f}, final {q1:.6f}", where)

    M = jnp.asarray(trained.points)
    step = som_batch_step.lower(
        M, jnp.asarray(X[:batch]), unit_coords(xdim, ydim, True),
        jnp.float32(ALPHA), jnp.float32(radius), gaussian=True,
        xdim=xdim, hexa=True).compile()
    say("A", f"step memory_analysis: {step.memory_analysis()}")

    q_ref = ref_qerror(trained, data_dev)
    with reference_ops():
        ref_map = fit(n)
    q_ref_lap = ref_qerror(ref_map, data_dev)
    say("A", f"reference qerror of the trained map {q_ref:.6f}; map trained "
        f"through the reference ops {q_ref_lap:.6f}")
    check(abs(q1 - q_ref) / q_ref <= 1e-4, f"fast qerror {q1} vs {q_ref}")
    check(q1 < q0, f"qerror did not drop: {q0} -> {q1}")
    check(abs(q1 - q_ref_lap) / q_ref_lap <= 0.02,
          f"final qerror {q1} vs reference-op lap {q_ref_lap}")
    return dict(q0=q0, q1=q1, q_ref=q_ref, q_ref_lap=q_ref_lap, lap_s=t_lap,
                eval_s=t_eval)


# ---------------------------------------------------------------------------
# phase B: the CLI, in this process
# ---------------------------------------------------------------------------

def phase_b(seed: int, where: str, n: int = 262144, xdim: int = MAP[0],
            ydim: int = MAP[1], d: int = DIM, buffer: int = CHUNK) -> dict:
    from som_lvq_pak_tpu import cli
    from som_lvq_pak_tpu.data import native_io
    from som_lvq_pak_tpu.data.dataset import Dataset
    from som_lvq_pak_tpu.data.io import read_data, write_data

    rng = np.random.default_rng(seed + 1)
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".smoke_") as tmp:
        din = os.path.join(tmp, "data.dat")
        c0, c1 = os.path.join(tmp, "init.cod"), os.path.join(tmp, "trained.cod")
        write_data(Dataset(points=mixture(rng, n, d)), din)
        say("B", f"parser: {'native' if native_io.available() else 'python'}")

        def run(*args):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([str(a) for a in args])
            check(rc == 0, f"somvq {args[0]} exited {rc}")
            return buf.getvalue(), time.perf_counter() - t0

        _, t = run("randinit", "-din", din, "-cout", c0, "-xdim", xdim,
                   "-ydim", ydim, "-topol", "hexa", "-neigh", "gaussian",
                   "-rand", seed + 1)
        say("B", f"randinit: {t:.2f} s", where)
        _, t = run("vsom", "-din", din, "-cin", c0, "-cout", c1, "-fast",
                   "-buffer", buffer, "-rlen", n, "-alpha", ALPHA,
                   "-radius", RADIUS)
        say("B", f"vsom -fast -buffer {buffer} -rlen {n}: {t:.2f} s", where)
        out, t = run("qerror", "-din", din, "-cin", c1, "-fast", "-v", 0)
        q_cli = float(out.strip().splitlines()[-1])
        say("B", f"qerror -fast: {q_cli:.6f} per sample, {t:.2f} s", where)
        q_ref = ref_qerror(read_data(c1), read_data(din))
    say("B", f"reference qerror of the written codebook {q_ref:.6f}")
    check(abs(q_cli - q_ref) / q_ref <= 1e-4, f"CLI qerror {q_cli} vs {q_ref}")
    return dict(q_cli=q_cli, q_ref=q_ref)


# ---------------------------------------------------------------------------
# phase C: LVQ at lvqexample's widths
# ---------------------------------------------------------------------------

def lvq_data(rng, n: int, d: int, classes: int, centres):
    from som_lvq_pak_tpu.data.dataset import Dataset
    from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS

    ids = np.asarray([GLOBAL_LABELS.to_index(f"c{i}") for i in range(classes)])
    lab = rng.integers(0, classes, size=n)
    X = centres[lab] + rng.normal(0.0, 1.0, size=(n, d)).astype(np.float32)
    return Dataset(points=X, labels=ids[lab].astype(np.int32))


def phase_c(seed: int, where: str, noc: int = 200, d: int = 20,
            classes: int = 10, n_train: int = 100000, n_test: int = 20000,
            batch: int = 256) -> dict:
    import jax
    import jax.numpy as jnp

    from som_lvq_pak_tpu.models.eval import accuracy
    from som_lvq_pak_tpu.models.fast import lvq23_batch_step
    from som_lvq_pak_tpu.models.lvq import eveninit
    from som_lvq_pak_tpu.models.trainer import OLVQ1Trainer

    rng = np.random.default_rng(seed + 2)
    centres = rng.normal(0.0, 0.7, size=(classes, d)).astype(np.float32)
    train = lvq_data(rng, n_train, d, classes, centres)
    test = lvq_data(rng, n_test, d, classes, centres)
    t0 = time.perf_counter()
    codes = eveninit(train, noc, mode="fast")
    say("C", f"eveninit {noc} codes from {n_train}: "
        f"{time.perf_counter() - t0:.2f} s", where)

    def train_and_score():
        t0 = time.perf_counter()
        out = OLVQ1Trainer(codes, batch_size=batch, seed=seed).fit(
            train, rlen=n_train)
        t_fit = time.perf_counter() - t0
        acc, _, _ = accuracy(test, out, parity=False)
        return out, acc, t_fit

    train_and_score()                      # compile
    trained, acc, t_fit = train_and_score()
    say("C", f"olvq1 {n_train} samples, B={batch}: {t_fit:.3f} s; "
        f"accuracy {acc:.2f} %", where)

    M = jnp.asarray(trained.points)
    cl = jnp.asarray(trained.first_labels())
    xb = jnp.asarray(train.points[:batch])
    xl = jnp.asarray(train.first_labels()[:batch])

    def lvq3():
        return lvq23_batch_step(M, cl, xb, xl, jnp.float32(0.03),
                                jnp.float32(0.3), epsilon=jnp.float32(0.1),
                                lvq3=True)

    got = np.asarray(jax.block_until_ready(lvq3()))
    with reference_ops():
        _, acc_ref, _ = train_and_score()
        ref3 = np.asarray(lvq3())
    err3 = float(np.max(np.abs(got - ref3)))
    say("C", f"reference-op olvq1 accuracy {acc_ref:.2f} %; lvq3 step "
        f"max|delta| vs reference {err3:.2e}")
    check(np.isfinite(got).all(), "lvq3 step not finite")
    check(acc > 200.0 / classes, f"accuracy {acc} not above twice chance")
    check(abs(acc - acc_ref) <= 0.5, f"accuracy {acc} vs reference {acc_ref}")
    check(err3 <= 1e-5 * max(1.0, float(np.max(np.abs(ref3)))),
          f"lvq3 step differs from reference by {err3}")
    return dict(acc=acc, acc_ref=acc_ref, lvq3_err=err3)


# ---------------------------------------------------------------------------
# phase D: four cards
# ---------------------------------------------------------------------------

def phase_d(seed: int, where: str, steps: int = 64, xdim: int = MAP[0],
            ydim: int = MAP[1], d: int = DIM, batch: int = BATCH) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from som_lvq_pak_tpu.data.dataset import Dataset
    from som_lvq_pak_tpu.models.common import alpha_schedule, radius_schedule
    from som_lvq_pak_tpu.models.fast import (
        lvq23_batch_step,
        olvq1_batch_step,
        som_batch_step,
        unit_coords,
    )
    from som_lvq_pak_tpu.models.som import find_qerror
    from som_lvq_pak_tpu.models.trainer import SOMTrainer
    from som_lvq_pak_tpu.parallel.mesh import make_mesh
    from som_lvq_pak_tpu.parallel.sharded import (
        make_sharded_lvq_train_step,
        make_sharded_olvq1_train_step,
        make_sharded_som_train_step,
    )

    check(len(jax.devices()) >= 4, f"needs 4 devices, has {len(jax.devices())}")
    rng = np.random.default_rng(seed + 3)
    n = steps * batch
    X = mixture(rng, n, d)
    codes = randinit_map(X, seed, xdim, ydim)
    data = Dataset(points=X)
    data_dev = Dataset(points=jnp.asarray(X))

    def train(mesh):
        t0 = time.perf_counter()
        out = SOMTrainer(codes, batch_size=batch, mesh=mesh, seed=seed).fit(
            data, rlen=n, alpha=ALPHA, radius=RADIUS)
        return out, time.perf_counter() - t0

    train(None)
    single, t1 = train(None)
    q1 = find_qerror(single, data_dev, mode="fast") / n
    say("D", f"one card: {steps} steps in {t1:.3f} s, qerror {q1:.6f}", where)

    # per-step check on the same batches: each step starts both layouts
    # from the one-card codebook, so a near-tie winner flip in one step
    # cannot compound through the later ones
    talp = alpha_schedule(n, ALPHA)[::batch][:steps]
    trad = radius_schedule(n, RADIUS)[::batch][:steps]
    coords = unit_coords(xdim, ydim, True)
    batches = [jnp.asarray(X[b * batch:(b + 1) * batch]) for b in range(steps)]
    out = {}
    for dd, dm in ((1, 4), (2, 2)):
        mesh = make_mesh(4, data=dd, model=dm)
        train(mesh)
        got, t = train(mesh)
        q = find_qerror(got, data_dev, mode="fast") / n
        drift = float(np.max(np.abs(got.points - single.points)))
        say("D", f"mesh data={dd} x model={dm}: {steps} steps in {t:.3f} s, "
            f"qerror {q:.6f}, max|codebook delta| after {steps} free-running "
            f"steps {drift:.2e}", where)
        step = make_sharded_som_train_step(mesh, gaussian=True, xdim=xdim,
                                           hexa=True)
        M = jnp.asarray(codes.points)
        worst = 0.0
        for b in range(steps):
            a, r = jnp.float32(talp[b]), jnp.float32(trad[b])
            ref = som_batch_step(M, batches[b], coords, a, r, gaussian=True,
                                 xdim=xdim, hexa=True)
            cs = jax.device_put(M, NamedSharding(mesh, P("model", None)))
            worst = max(worst, float(jnp.max(jnp.abs(
                step(cs, batches[b], a, r) - ref))))
            M = ref
        scale = float(np.max(np.abs(codes.points)))
        say("D", f"mesh data={dd} x model={dm}: per-step max|codebook delta| "
            f"vs one card over {steps} steps {worst:.2e} "
            f"= {worst / scale:.2e} x max|codebook|")
        # the update's W^T X runs in TF32 on the card, and each layout's
        # product has another shape: the bound of a TF32 product
        check(worst <= 1e-3 * scale,
              f"mesh {dd}x{dm}: per-step codebook delta {worst}")
        check(abs(q - q1) / q1 <= 1e-3, f"mesh {dd}x{dm}: qerror {q} vs {q1}")
        out[f"mesh_{dd}x{dm}"] = dict(step_err=worst, drift=drift, qerror=q,
                                      s=t)

    # sharded LVQ steps on the north-star codebook size, 10 classes
    M = jnp.asarray(codes.points)
    clab = jnp.asarray(rng.integers(1, 11, size=codes.n), jnp.int32)
    xb = jnp.asarray(X[:batch])
    xl = jnp.asarray(rng.integers(1, 11, size=batch), jnp.int32)
    alphas = jnp.full((codes.n,), 0.3, jnp.float32)
    ref_c, ref_a = olvq1_batch_step(M, clab, alphas, xb, xl)
    ref3 = lvq23_batch_step(M, clab, xb, xl, jnp.float32(0.05), 0.3,
                            epsilon=0.1, lvq3=True)
    for dd, dm in ((1, 4), (2, 2)):
        mesh = make_mesh(4, data=dd, model=dm)
        cs = jax.device_put(M, NamedSharding(mesh, P("model", None)))
        xs = jax.device_put(xb, NamedSharding(mesh, P("data", None)))
        xls = jax.device_put(xl, NamedSharding(mesh, P("data")))
        oc, oa = make_sharded_olvq1_train_step(mesh)(cs, clab, alphas, xs, xls)
        o3 = make_sharded_lvq_train_step(mesh, algorithm="lvq3", winlen=0.3,
                                         epsilon=0.1)(cs, clab, xs, xls,
                                                      jnp.float32(0.05))
        np.testing.assert_allclose(np.asarray(oc), np.asarray(ref_c),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(oa), np.asarray(ref_a),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(o3), np.asarray(ref3),
                                   rtol=1e-5, atol=1e-5)
        say("D", f"mesh data={dd} x model={dm}: sharded olvq1 and lvq3 steps "
            "equal one card (rtol/atol 1e-5)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase D, on four cards")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from som_lvq_pak_tpu.utils.compile_cache import enable_compile_cache

    say("setup", f"compile cache: {enable_compile_cache()}")
    where = card()
    if args.four_cards:
        phase_d(args.seed, where)
    else:
        for phase in (phase_ops, phase_a, phase_b, phase_c):
            phase(args.seed, where)
    say("card", where)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
