"""Golden parity tests for the SOM path: bit-identical codebook files and
the measured quantization-error golden from BASELINE.md (3.571006)."""

import io
import os

import numpy as np
import pytest

from som_lvq_pak_tpu.data import Dataset, Neighborhood, Topology, read_data, write_data
from som_lvq_pak_tpu.models.som import find_qerror, find_qerror2, lininit, randinit, som_train
from som_lvq_pak_tpu.utils.rng import CRandom


def _write_str(ds, comments=None):
    buf = io.StringIO()
    write_data(ds, None, comments=comments, fileobj=buf)
    return buf.getvalue()


@pytest.fixture(scope="module")
def ex_dat():
    path = "/root/reference/ex.dat"
    if not os.path.exists(path):
        pytest.skip("reference data missing")
    return read_data(path)


def test_randinit_matches_golden(ex_dat, golden_dir):
    rng = CRandom()
    rng.init_random(123)
    codes = randinit(ex_dat, Topology.HEXA, Neighborhood.BUBBLE, 12, 8, rng)
    ours = _write_str(codes, comments="# random seed: 123\n")
    with open(os.path.join(golden_dir, "som_r.cod")) as f:
        assert ours == f.read()


def test_vsom_coarse_matches_golden(golden_dir, ex_dat):
    codes = read_data(os.path.join(golden_dir, "som_r.cod"))
    out = som_train(codes, ex_dat, rlen=1000, alpha=0.05, radius=10)
    with open(os.path.join(golden_dir, "som_1.cod")) as f:
        assert _write_str(out) == f.read()


def test_vsom_fine_matches_golden(golden_dir, ex_dat):
    codes = read_data(os.path.join(golden_dir, "som_1.cod"))
    out = som_train(codes, ex_dat, rlen=10000, alpha=0.02, radius=3)
    with open(os.path.join(golden_dir, "som_2.cod")) as f:
        assert _write_str(out) == f.read()


def test_qerror_golden(golden_dir, ex_dat):
    codes = read_data(os.path.join(golden_dir, "som_2.cod"))
    q = find_qerror(codes, ex_dat)
    per_sample = np.float32(q) / np.float32(ex_dat.n)
    assert "%f" % per_sample == "3.571006"


def test_qerror_fast_close(golden_dir, ex_dat):
    codes = read_data(os.path.join(golden_dir, "som_2.cod"))
    q_par = find_qerror(codes, ex_dat, mode="parity")
    q_fast = find_qerror(codes, ex_dat, mode="fast")
    # the matmul form |x|^2-2xm+|m|^2 loses a few ulps to cancellation
    assert abs(q_par - q_fast) / q_par < 1e-4


def test_qerror_fast_whole_array_path(golden_dir, ex_dat, monkeypatch):
    """Large evaluations run the XLA winner search over row chunks
    (ops.dispatch._XLA_BLOCK_ELEMS); shrinking the block forces it at
    test size. It must agree with the one-block run, masked included
    (all-masked rows contribute 0, som_rout.c:704-713)."""
    from som_lvq_pak_tpu.ops import dispatch

    codes = read_data(os.path.join(golden_dir, "som_2.cod"))
    q_whole = find_qerror(codes, ex_dat, mode="fast")
    monkeypatch.setattr(dispatch, "_XLA_BLOCK_ELEMS", 256 * codes.n)
    assert ex_dat.n > 256
    q_chunked = find_qerror(codes, ex_dat, mode="fast")
    assert abs(q_whole - q_chunked) / q_chunked < 1e-5

    # masked variant: mask one component of some rows, ALL of others
    import dataclasses

    mask = np.zeros((ex_dat.n, ex_dat.dim), np.uint8)
    mask[10:200, 0] = 1
    mask[300:310, :] = 1  # empty samples: skipped entirely
    masked = dataclasses.replace(ex_dat, mask=mask)
    qm_chunked = find_qerror(codes, masked, mode="fast")
    monkeypatch.undo()
    qm_whole = find_qerror(codes, masked, mode="fast")
    assert abs(qm_whole - qm_chunked) / qm_chunked < 1e-5
    qm_par = find_qerror(codes, masked, mode="parity")
    assert abs(qm_whole - qm_par) / qm_par < 1e-4


def test_qerror2_golden(golden_dir, ex_dat):
    codes = read_data(os.path.join(golden_dir, "som_2.cod"))
    q = find_qerror2(codes, ex_dat, radius=3.0)
    per_sample = np.float32(q) / np.float32(ex_dat.n)
    assert "%f" % per_sample == "3844.190918"


def test_gaussian_rect_pipeline_matches_golden(golden_dir, ex_dat):
    """lininit (power-iteration parity, seed 7) + gaussian vsom, rect map."""
    rng = CRandom()
    rng.init_random(7)
    codes = lininit(ex_dat, Topology.RECT, Neighborhood.GAUSSIAN, 12, 8, rng)
    with open(os.path.join(golden_dir, "som_lin.cod")) as f:
        assert _write_str(codes, comments="# random seed: 7\n") == f.read()

    golden = read_data(os.path.join(golden_dir, "som_lin.cod"))
    out = som_train(golden, ex_dat, rlen=500, alpha=0.05, radius=5)
    with open(os.path.join(golden_dir, "som_g.cod")) as f:
        assert _write_str(out) == f.read()


def test_vsom_random_order_matches_golden(golden_dir, ex_dat):
    """-rand 123 enables the LCG shuffle of the sample order."""
    codes = read_data(os.path.join(golden_dir, "som_r.cod"))
    rng = CRandom()
    rng.init_random(123)
    out = som_train(
        codes, ex_dat, rlen=1000, alpha=0.05, radius=10, random_order=True, rng=rng
    )
    with open(os.path.join(golden_dir, "som_rand.cod")) as f:
        assert _write_str(out) == f.read()


def test_vsom_inverse_t_matches_golden(golden_dir, ex_dat):
    codes = read_data(os.path.join(golden_dir, "som_r.cod"))
    out = som_train(
        codes, ex_dat, rlen=1000, alpha=0.05, radius=10, alpha_type="inverse_t"
    )
    with open(os.path.join(golden_dir, "som_invt.cod")) as f:
        assert _write_str(out) == f.read()


def test_fast_mode_close_to_parity(golden_dir, ex_dat):
    """The jitted online trainer follows the parity path to float
    tolerance.  Individual BMU decisions can flip when two codes are
    within cancellation noise of each other, which makes long runs
    diverge point-wise (chaotic map) — so compare the resulting map
    quality (qerror), plus a short run point-wise."""
    codes = read_data(os.path.join(golden_dir, "som_r.cod"))
    par = som_train(codes, ex_dat, rlen=60, alpha=0.05, radius=10, mode="parity")
    fast = som_train(codes, ex_dat, rlen=60, alpha=0.05, radius=10, mode="fast")
    assert np.allclose(par.points, fast.points, rtol=1e-3, atol=1e-2)

    par2 = som_train(codes, ex_dat, rlen=1000, alpha=0.05, radius=10, mode="parity")
    fast2 = som_train(codes, ex_dat, rlen=1000, alpha=0.05, radius=10, mode="fast")
    qp = find_qerror(par2, ex_dat, mode="fast")
    qf = find_qerror(fast2, ex_dat, mode="fast")
    assert abs(qp - qf) / qp < 2e-2


# ---------------------------------------------------------------------------
# weight= / buffered-streaming / fixed= parity (goldens generated with the
# compiled reference: vsom -weights 1 / -buffer B -rand 3 / -fixed 1)
# ---------------------------------------------------------------------------

@pytest.fixture()
def wmask_dat(golden_dir):
    """120x7 synthetic file with masked comps, labels and weight= tokens."""
    return read_data(os.path.join(golden_dir, "wmask.dat"))


def test_vsom_weights_matches_golden(golden_dir, wmask_dat):
    """talp = 1 - (float)pow(1-talp, weight) with the pow result truncated
    to float before the subtraction, and weight defaulting to the 0
    sentinel for entries without a token (som_rout.c:622-624,
    datafile.c:497)."""
    codes = read_data(os.path.join(golden_dir, "wmask_r.cod"))
    out = som_train(codes, wmask_dat, rlen=300, alpha=0.05, radius=4,
                    use_weights=True)
    with open(os.path.join(golden_dir, "wmask_w.cod")) as f:
        assert _write_str(out) == f.read()


def test_vsom_buffered_random_order_matches_golden(golden_dir, wmask_dat):
    """-buffer B with -rand shuffles each B-entry refill independently
    with the continuing LCG stream, every lap (datafile.c:268-270,
    338-341)."""
    codes = read_data(os.path.join(golden_dir, "wmask_r.cod"))
    rng = CRandom()
    rng.init_random(3)
    out = som_train(codes, wmask_dat, rlen=300, alpha=0.05, radius=4,
                    random_order=True, rng=rng, buffer=37)
    with open(os.path.join(golden_dir, "wmask_br.cod")) as f:
        assert _write_str(out) == f.read()


def test_vsom_buffer_equals_n_matches_golden(golden_dir, wmask_dat):
    """buffer == n stays in buffered mode (refill breaks on noc >= buffer
    before EOF), so the whole file is reshuffled every lap — unlike
    buffer > n which degrades to the shuffle-once LOADMODE_ALL."""
    codes = read_data(os.path.join(golden_dir, "wmask_r.cod"))
    rng = CRandom()
    rng.init_random(3)
    out = som_train(codes, wmask_dat, rlen=300, alpha=0.05, radius=4,
                    random_order=True, rng=rng, buffer=wmask_dat.n)
    with open(os.path.join(golden_dir, "wmask_b120.cod")) as f:
        assert _write_str(out) == f.read()


def test_vsom_fixed_points_matches_golden(golden_dir):
    """fixed=x,y samples bypass the winner search (som_rout.c:628-632)."""
    data = read_data(os.path.join(golden_dir, "fix.dat"))
    codes = read_data(os.path.join(golden_dir, "fix_r.cod"))
    out = som_train(codes, data, rlen=200, alpha=0.1, radius=2,
                    use_fixed=True)
    with open(os.path.join(golden_dir, "fix_fv.cod")) as f:
        assert _write_str(out) == f.read()


def test_qerror2_fast_close(golden_dir, ex_dat):
    """The device qerror2 path tracks the C parity value closely on both
    neighborhood types (quality tolerance; parity is the bit anchor)."""
    codes = read_data(os.path.join(golden_dir, "som_2.cod"))
    q_par = find_qerror2(codes, ex_dat, radius=3.0, mode="parity")
    q_fast = find_qerror2(codes, ex_dat, radius=3.0, mode="fast")
    # parity squares the f32-rounded sqrt (vector_dist_euc) and does
    # two-level f32 accumulation; fast sums squared distances directly
    assert abs(q_par - q_fast) / q_par < 5e-4
    # gaussian neighborhood variant
    from dataclasses import replace as _replace

    from som_lvq_pak_tpu.data.dataset import Neighborhood as _N

    gcodes = _replace(codes, neigh=_N.GAUSSIAN)
    qg_par = find_qerror2(gcodes, ex_dat, radius=3.0, mode="parity")
    qg_fast = find_qerror2(gcodes, ex_dat, radius=3.0, mode="fast")
    assert abs(qg_par - qg_fast) / qg_par < 5e-4


def test_qerror_fast_masked_and_remainder(golden_dir, ex_dat):
    """Fast qerror handles masked components, empty rows, and a data
    size that is not a multiple of the chunk shape."""
    import numpy as _np

    from dataclasses import replace as _replace

    codes = read_data(os.path.join(golden_dir, "som_2.cod"))
    sub = ex_dat.take(_np.arange(1001))  # odd size -> padded last chunk
    mask = _np.zeros((sub.n, sub.dim), _np.uint8)
    mask[::7, 2] = 1     # scattered masked comps
    mask[3] = 1          # an empty (all-masked) row
    msub = _replace(sub, mask=mask)
    q_par = find_qerror(msub, codes, mode="parity") if False else None
    qp = find_qerror(codes, msub, mode="parity")
    qf = find_qerror(codes, msub, mode="fast")
    assert abs(qp - qf) / qp < 1e-4


def test_library_pipeline_roundtrip_golden(ref_dir, ex_dat, tmp_path):
    """The README library quick-start, verified: chaining stages through
    the %g text round-trip (like the reference programs, which exchange
    codebook FILES) reproduces the 3.571006 golden exactly; the C value
    bakes those round-trips in."""
    from som_lvq_pak_tpu.data.io import write_data

    rng = CRandom()
    rng.init_random(123)
    codes = randinit(ex_dat, Topology.HEXA, Neighborhood.BUBBLE, 12, 8, rng)
    p = str(tmp_path / "s.cod")
    write_data(codes, p)
    codes = read_data(p)
    codes = som_train(codes, ex_dat, rlen=1000, alpha=0.05, radius=10.0)
    write_data(codes, p)
    codes = read_data(p)
    codes = som_train(codes, ex_dat, rlen=10000, alpha=0.02, radius=3.0)
    write_data(codes, p)
    codes = read_data(p)
    q = find_qerror(codes, ex_dat)
    assert "%f" % (np.float32(q) / np.float32(ex_dat.n)) == "3.571006"
