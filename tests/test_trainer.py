"""Production trainer drivers: quality vs parity, streaming input,
checkpoint/resume, sharded execution."""

import os

import numpy as np
import pytest

from som_lvq_pak_tpu.data.dataset import Neighborhood, Topology
from som_lvq_pak_tpu.data.io import read_data
from som_lvq_pak_tpu.data.streaming import StreamingReader
from som_lvq_pak_tpu.models import som
from som_lvq_pak_tpu.models.trainer import OLVQ1Trainer, SOMTrainer
from som_lvq_pak_tpu.utils.rng import CRandom


@pytest.fixture
def ex_dat(ref_dir):
    return read_data(os.path.join(ref_dir, "ex.dat"))


def _qerror_per_sample(codes, data):
    return som.find_qerror(codes, data, mode="fast") / data.n


def test_som_trainer_quality(ex_dat):
    """Minibatch training reaches a quantization error in the same range
    as the reference pipeline (3.57 per sample on ex.dat)."""
    init = som.randinit(ex_dat, Topology.HEXA, Neighborhood.BUBBLE, 12, 8,
                        CRandom(123))
    q0 = _qerror_per_sample(init, ex_dat)
    tr = SOMTrainer(init, batch_size=64, update="mean", seed=1)
    out = tr.fit(ex_dat, rlen=11000, alpha=0.05, radius=10.0)
    q1 = _qerror_per_sample(out, ex_dat)
    assert q1 < q0 * 0.6
    assert q1 < 4.6  # parity pipeline reaches 3.571; batch mode close


def test_som_trainer_streaming_input(ex_dat, ref_dir):
    init = som.randinit(ex_dat, Topology.HEXA, Neighborhood.BUBBLE, 8, 6,
                        CRandom(7))
    sr = StreamingReader(os.path.join(ref_dir, "ex.dat"), buffer=512)
    tr = SOMTrainer(init, batch_size=128, update="mean")
    out = tr.fit(sr.chunks(laps=None), rlen=2048, alpha=0.05, radius=6.0)
    assert _qerror_per_sample(out, ex_dat) < _qerror_per_sample(init, ex_dat)


def test_som_trainer_checkpoint_resume(ex_dat, tmp_path):
    init = som.randinit(ex_dat, Topology.HEXA, Neighborhood.BUBBLE, 6, 4,
                        CRandom(3))
    d = str(tmp_path / "ck")
    tr = SOMTrainer(init, batch_size=128, checkpoint_dir=d,
                    checkpoint_interval=2, seed=5)
    full = tr.fit(ex_dat, rlen=128 * 8, alpha=0.05, radius=4.0)

    # re-run from the 4-step checkpoint: must reproduce the final map
    tr2 = SOMTrainer(init, batch_size=128, checkpoint_dir=d,
                     seed=5)
    st = tr2.ckpt.load(4)
    assert st is not None and st.step == 4
    # drop newer checkpoints, then resume
    for s in tr2.ckpt.steps():
        if s > 4:
            os.remove(os.path.join(d, f"step_{s}.npz"))
    resumed = tr2.fit(ex_dat, rlen=128 * 8, alpha=0.05, radius=4.0, resume=True)
    np.testing.assert_allclose(resumed.points, full.points, rtol=1e-6, atol=1e-6)


def test_olvq1_trainer_improves_accuracy(ref_dir):
    from som_lvq_pak_tpu.models import eval as ev
    from som_lvq_pak_tpu.models import lvq

    d1 = read_data(os.path.join(ref_dir, "ex1.dat"))
    d2 = read_data(os.path.join(ref_dir, "ex2.dat"))
    codes = lvq.eveninit(d1, noc=200)
    pct0, _, _ = ev.accuracy(d2, codes)
    tr = OLVQ1Trainer(codes, batch_size=32, seed=2)
    out = tr.fit(d1, rlen=5000)
    pct1, _, _ = ev.accuracy(d2, out)
    assert pct1 > pct0 - 0.5  # batch olvq1 must not degrade the init
    assert pct1 > 85.0


def test_som_trainer_sharded(ex_dat):
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from som_lvq_pak_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    init = som.randinit(ex_dat, Topology.HEXA, Neighborhood.BUBBLE, 8, 4,
                        CRandom(11))
    tr = SOMTrainer(init, batch_size=64, mesh=mesh, seed=4)
    out = tr.fit(ex_dat, rlen=1024, alpha=0.05, radius=4.0)
    assert _qerror_per_sample(out, ex_dat) < _qerror_per_sample(init, ex_dat)


def test_olvq1_batch_alpha_saturates():
    """Many wrong hits on one code in a single batch must saturate its
    learning rate at the clip, never go negative (the sequential
    reference clips after every sample, lvq_rout.c:668-672)."""
    import jax.numpy as jnp

    from som_lvq_pak_tpu.models.fast import olvq1_batch_step

    codes = jnp.asarray([[0.0, 0.0], [10.0, 10.0]], dtype=jnp.float32)
    clabels = jnp.asarray([1, 2])
    alphas = jnp.asarray([0.3, 0.3], dtype=jnp.float32)
    # 8 samples, all winning code 0, all labeled wrong
    xb = jnp.tile(jnp.asarray([[0.1, 0.1]], dtype=jnp.float32), (8, 1))
    xl = jnp.full((8,), 2)
    _, new_a = olvq1_batch_step(codes, clabels, alphas, xb, xl,
                                clip=0.3)
    a = np.asarray(new_a)
    assert (a > 0).all() and (a <= 0.3 + 1e-6).all(), a


def test_som_trainer_stream_exhaustion_raises(ex_dat, ref_dir):
    """A stream that runs dry before rlen must raise (silent
    under-training was a r1 defect), unless allow_short_stream=True."""
    init = som.randinit(ex_dat, Topology.HEXA, Neighborhood.BUBBLE, 6, 4,
                        CRandom(7))
    sr = StreamingReader(os.path.join(ref_dir, "ex.dat"), buffer=512)
    tr = SOMTrainer(init, batch_size=128)
    with pytest.raises(RuntimeError, match="stream exhausted"):
        tr.fit(sr.chunks(laps=1), rlen=8192, alpha=0.05, radius=4.0)

    sr = StreamingReader(os.path.join(ref_dir, "ex.dat"), buffer=512)
    tr = SOMTrainer(init, batch_size=128)
    out = tr.fit(sr.chunks(laps=1), rlen=8192, alpha=0.05, radius=4.0,
                 allow_short_stream=True)
    assert np.isfinite(out.points).all()


def test_som_trainer_streaming_masked_weighted(golden_dir):
    """Streaming chunks carrying masks and weights flow through to the
    masked minibatch step."""
    sr = StreamingReader(os.path.join(golden_dir, "wmask.dat"), buffer=32)
    codes = read_data(os.path.join(golden_dir, "wmask_r.cod"))
    data = read_data(os.path.join(golden_dir, "wmask.dat"))
    tr = SOMTrainer(codes, batch_size=16, seed=3)
    out = tr.fit(sr.chunks(laps=None), rlen=480, alpha=0.05, radius=3.0,
                 use_weights=True)
    assert np.isfinite(out.points).all()
    q = som.find_qerror(out, data, mode="parity") / data.n
    q0 = som.find_qerror(codes, data, mode="parity") / data.n
    assert q < 1.5 * q0


def test_olvq1_trainer_streaming_input(ref_dir):
    """OLVQ1Trainer with a StreamingReader input (the -buffer analogue
    for LVQ training, lvqtrain.c:181) trains to a usable accuracy."""
    from som_lvq_pak_tpu.models import eval as ev
    from som_lvq_pak_tpu.models import lvq

    d1 = read_data(os.path.join(ref_dir, "ex1.dat"))
    d2 = read_data(os.path.join(ref_dir, "ex2.dat"))
    codes = lvq.eveninit(d1, noc=100)
    sr = StreamingReader(os.path.join(ref_dir, "ex1.dat"), buffer=256)
    tr = OLVQ1Trainer(codes, batch_size=64, seed=2)
    out = tr.fit(sr.chunks(laps=None), rlen=3000)
    pct, _, _ = ev.accuracy(d2, out)
    assert pct > 82.0

    sr = StreamingReader(os.path.join(ref_dir, "ex1.dat"), buffer=256)
    tr = OLVQ1Trainer(codes, batch_size=64, seed=2)
    with pytest.raises(RuntimeError, match="stream exhausted"):
        tr.fit(sr.chunks(laps=1), rlen=30000)


def test_lvq_trainer_streamed_batches_exact(ref_dir):
    """The LVQ streamed superblock path must feed EXACTLY the stream's
    batches in order — including a masked chunk mid-stream (its batch
    rides the masked kernel; clean batches in the same transfer block
    keep mask=None) — matching a manual lvq1_batch_step drive."""
    import jax.numpy as jnp

    from som_lvq_pak_tpu.data.dataset import Dataset
    from som_lvq_pak_tpu.models import lvq
    from som_lvq_pak_tpu.models.fast import lvq1_batch_step

    d1 = read_data(os.path.join(ref_dir, "ex1.dat"))
    codes = lvq.eveninit(d1, noc=50)
    X = d1.points[:256]
    L = d1.first_labels()[:256]
    mask = np.zeros((64, d1.dim), np.uint8)
    mask[:, 3] = 1

    def stream():
        yield Dataset(points=X[:64], labels=L[:64])
        yield Dataset(points=X[64:128], labels=L[64:128], mask=mask)
        yield Dataset(points=X[128:192], labels=L[128:192])
        yield Dataset(points=X[192:256], labels=L[192:256])

    from som_lvq_pak_tpu.models.trainer import LVQTrainer

    tr = LVQTrainer(codes, algorithm="lvq1", batch_size=64,
                    seed=0)
    out = tr.fit(stream(), rlen=256, alpha=0.05)

    from som_lvq_pak_tpu.models.common import alpha_schedule

    talp = alpha_schedule(256, 0.05, "linear")[::64][:4]
    M = jnp.asarray(codes.points)
    cl = jnp.asarray(codes.first_labels())
    for b in range(4):
        mb = jnp.asarray(mask) if b == 1 else None
        M = lvq1_batch_step(M, cl, jnp.asarray(X[b * 64:(b + 1) * 64]),
                            jnp.asarray(L[b * 64:(b + 1) * 64]),
                            jnp.float32(talp[b]), mask=mb)
    np.testing.assert_allclose(out.points, np.asarray(M), rtol=1e-6,
                               atol=1e-6)


def test_som_trainer_streaming_resume_fast_forwards(ex_dat, ref_dir,
                                                    tmp_path):
    """Resume with a streaming input must fast-forward the stream by
    start*batch_size samples so resumed batches train on their original
    stream positions (ADVICE r2: it used to replay the stream head)."""
    init = som.randinit(ex_dat, Topology.HEXA, Neighborhood.BUBBLE, 6, 4,
                        CRandom(3))
    path = os.path.join(ref_dir, "ex.dat")
    d = str(tmp_path / "cksr")
    kw = dict(batch_size=128, seed=5, update="mean")
    tr = SOMTrainer(init, checkpoint_dir=d, checkpoint_interval=3, **kw)
    full = tr.fit(StreamingReader(path, buffer=512).chunks(laps=None),
                  rlen=128 * 10, alpha=0.05, radius=4.0)

    tr2 = SOMTrainer(init, checkpoint_dir=d, **kw)
    assert 6 in tr2.ckpt.steps(), tr2.ckpt.steps()
    for s in tr2.ckpt.steps():
        if s > 6:
            os.remove(os.path.join(d, f"step_{s}.npz"))
    resumed = tr2.fit(StreamingReader(path, buffer=512).chunks(laps=None),
                      rlen=128 * 10, alpha=0.05, radius=4.0)
    np.testing.assert_allclose(resumed.points, full.points,
                               rtol=1e-5, atol=1e-5)


def test_olvq1_streaming_resume_fast_forwards(ref_dir, tmp_path):
    """Same stream fast-forward contract for OLVQ1Trainer."""
    from som_lvq_pak_tpu.models import lvq

    d1 = read_data(os.path.join(ref_dir, "ex1.dat"))
    codes = lvq.eveninit(d1, noc=100)
    path = os.path.join(ref_dir, "ex1.dat")
    d = str(tmp_path / "ckolvq")
    kw = dict(batch_size=64, seed=2)
    tr = OLVQ1Trainer(codes, checkpoint_dir=d, checkpoint_interval=4, **kw)
    full = tr.fit(StreamingReader(path, buffer=256).chunks(laps=None),
                  rlen=64 * 12)

    tr2 = OLVQ1Trainer(codes, checkpoint_dir=d, **kw)
    assert 8 in tr2.ckpt.steps(), tr2.ckpt.steps()
    for s in tr2.ckpt.steps():
        if s > 8:
            os.remove(os.path.join(d, f"step_{s}.npz"))
    resumed = tr2.fit(StreamingReader(path, buffer=256).chunks(laps=None),
                      rlen=64 * 12)
    np.testing.assert_allclose(resumed.points, full.points,
                               rtol=1e-6, atol=1e-6)


def test_som_trainer_stream_bf16_quality(ex_dat):
    """stream_bf16=True ships streamed batches in bfloat16 (halving the
    host->device bytes);
    only the input quantization changes, so the trained map's qerror
    must stay within a fraction of a percent of the f32-streamed run."""
    from som_lvq_pak_tpu.data.dataset import Dataset

    init = som.randinit(ex_dat, Topology.HEXA, Neighborhood.GAUSSIAN, 8, 8,
                        CRandom(11))
    X = ex_dat.points[:2048]

    def stream():
        for lo in range(0, 2048, 256):
            yield Dataset(points=X[lo:lo + 256])

    out_f32 = SOMTrainer(init, batch_size=256).fit(
        stream(), rlen=2048, alpha=0.05, radius=4.0)
    out_bf16 = SOMTrainer(init, batch_size=256,
                          stream_bf16=True).fit(
        stream(), rlen=2048, alpha=0.05, radius=4.0)
    data = Dataset(points=X)
    q32 = som.find_qerror(out_f32, data, mode="fast") / data.n
    q16 = som.find_qerror(out_bf16, data, mode="fast") / data.n
    assert abs(q16 - q32) / q32 < 0.005, (q32, q16)


def test_lvq_trainer_mesh_matches_single_device(ref_dir):
    """LVQTrainer on the (data, model) mesh equals the single-device
    run batch for batch (same keybox seed -> same batches)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from som_lvq_pak_tpu.models.trainer import LVQTrainer
    from som_lvq_pak_tpu.parallel.mesh import make_mesh

    data = read_data(os.path.join(ref_dir, "ex1.dat"))
    base = data.take(np.arange(128))  # 128 codes from the data
    mesh = make_mesh(8)
    for algorithm in ("lvq1", "lvq3"):
        tr_m = LVQTrainer(base, algorithm=algorithm, batch_size=64,
                          mesh=mesh, seed=9)
        out_m = tr_m.fit(data, rlen=64 * 6, alpha=0.05)
        tr_s = LVQTrainer(base, algorithm=algorithm, batch_size=64,
                          seed=9)
        out_s = tr_s.fit(data, rlen=64 * 6, alpha=0.05)
        np.testing.assert_allclose(out_m.points, out_s.points,
                                   rtol=1e-5, atol=1e-5)

