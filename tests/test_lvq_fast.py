"""Fast-mode lvq2/lvq3 and the minibatch LVQTrainer driver.

The parity loops are anchored byte-for-byte by the goldens
(test_lvq_parity.py); these tests anchor the device paths: the jitted
sequential scan (_lvq23_fast, lvq_rout.c:702-916 semantics) must land
within a point of parity accuracy on the lvqexample data, and the
minibatch LVQTrainer (lvqtrain.c:214-237's algorithm dispatch as a
production driver) must fine-tune without losing the 90.11 % golden
level (BASELINE.md)."""

import os

import numpy as np
import pytest

from som_lvq_pak_tpu.data import read_data
from som_lvq_pak_tpu.models.eval import accuracy
from som_lvq_pak_tpu.models.lvq import lvq1_train, lvq2_train, lvq3_train
from som_lvq_pak_tpu.models.trainer import LVQTrainer

PARITY_ACCURACY = 90.11  # lvqexample golden (BASELINE.md)


@pytest.fixture
def base(golden_dir):
    return read_data(os.path.join(golden_dir, "lvq_b.cod"))


@pytest.fixture
def ex1(ref_dir):
    return read_data(os.path.join(ref_dir, "ex1.dat"))


@pytest.fixture
def ex2(ref_dir):
    return read_data(os.path.join(ref_dir, "ex2.dat"))


def test_lvq2_fast_matches_parity_quality(base, ex1, ex2):
    """mode='fast' is honored (was silently ignored) and the jitted scan
    lands within a point of the parity loop's accuracy."""
    par = lvq2_train(base, ex1, rlen=2000, alpha=0.05, winlen=0.3)
    fast = lvq2_train(base, ex1, rlen=2000, alpha=0.05, winlen=0.3,
                      mode="fast")
    assert not np.array_equal(fast.points, base.points), "fast mode did nothing"
    p_par, _, _ = accuracy(ex2, par)
    p_fast, _, _ = accuracy(ex2, fast)
    assert abs(p_par - p_fast) < 1.0, (p_par, p_fast)


def test_lvq3_fast_matches_parity_quality(base, ex1, ex2):
    par = lvq3_train(base, ex1, rlen=2000, alpha=0.05, winlen=0.3,
                     epsilon=0.1)
    fast = lvq3_train(base, ex1, rlen=2000, alpha=0.05, winlen=0.3,
                      epsilon=0.1, mode="fast")
    assert not np.array_equal(fast.points, base.points), "fast mode did nothing"
    p_par, _, _ = accuracy(ex2, par)
    p_fast, _, _ = accuracy(ex2, fast)
    assert abs(p_par - p_fast) < 1.0, (p_par, p_fast)


def test_lvq23_unknown_mode_raises(base, ex1):
    with pytest.raises(ValueError, match="mode"):
        lvq2_train(base, ex1, rlen=10, alpha=0.05, winlen=0.3, mode="bogus")


def test_lvq1_fast_still_works(base, ex1, ex2):
    """Regression guard for the existing lvq1 fast path alongside the
    new mode plumbing."""
    fast = lvq1_train(base, ex1, rlen=2000, alpha=0.05, mode="fast")
    pct, _, _ = accuracy(ex2, fast)
    assert pct > PARITY_ACCURACY - 2.0, pct


@pytest.mark.parametrize("algorithm", ["lvq1", "lvq2", "lvq3"])
def test_lvq_trainer_accuracy(base, ex1, ex2, algorithm):
    """Minibatch LVQTrainer fine-tuning from the balanced codebook must
    hold the golden accuracy level (the reference's retrain stage,
    lvq_run.c:877-931, runs lvq1/2/3 exactly this way)."""
    tr = LVQTrainer(base, algorithm=algorithm, batch_size=64,
                    seed=2)
    out = tr.fit(ex1, rlen=5000, alpha=0.05)
    pct, _, _ = accuracy(ex2, out)
    assert pct > PARITY_ACCURACY - 2.0, f"{algorithm}: {pct:.2f}%"


def test_lvq_trainer_rejects_unknown_algorithm(base):
    with pytest.raises(ValueError, match="algorithm"):
        LVQTrainer(base, algorithm="olvq1")


def test_lvq_trainer_checkpoint_resume(base, ex1, tmp_path):
    """Interval checkpoints + resume reproduce the uninterrupted run
    (the PRNG key is checkpointed, so resumed batches are identical)."""
    d = str(tmp_path / "ck")
    tr = LVQTrainer(base, algorithm="lvq1", batch_size=64,
                    checkpoint_dir=d, checkpoint_interval=4,
                    seed=3)
    full = tr.fit(ex1, rlen=64 * 12, alpha=0.05)

    tr2 = LVQTrainer(base, algorithm="lvq1", batch_size=64,
                     checkpoint_dir=d, seed=3)
    st = tr2.ckpt.load(8)
    assert st is not None and st.step == 8
    # drop newer checkpoints so the resume starts at step 8
    for s in tr2.ckpt.steps():
        if s > 8:
            os.remove(os.path.join(d, f"step_{s}.npz"))
    out = tr2.fit(ex1, rlen=64 * 12, alpha=0.05)
    np.testing.assert_allclose(out.points, full.points, rtol=1e-6, atol=1e-6)
