"""CLI layer tests: every tool drives through `somvq <tool>` flags and
produces byte-identical files/reports to the reference binaries (golden
files in tests/golden were generated with the compiled reference)."""

import io
import os
import sys

import pytest

from som_lvq_pak_tpu.cli import main, tool_names
from som_lvq_pak_tpu.cli.params import verbose


@pytest.fixture(autouse=True)
def reset_verbosity():
    verbose(1)
    yield
    verbose(1)


def run(tool, *flags, stdin=None):
    """Run a tool in-process, capturing stdout."""
    old_out, old_in = sys.stdout, sys.stdin
    sys.stdout = io.StringIO()
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        rc = main([tool] + [str(f) for f in flags])
        return rc, sys.stdout.getvalue()
    finally:
        sys.stdout = old_out
        sys.stdin = old_in


def test_registry_covers_reference_programs():
    names = set(tool_names())
    for prog in [
        "lvqtrain", "lvq1", "lvq2", "lvq3", "olvq1", "eveninit", "propinit",
        "balance", "accuracy", "classify", "knntest", "mcnemar", "cmatr",
        "mindist", "stddev", "pick", "extract", "setlabel", "showlabs",
        "elimin", "sammon", "mapinit", "randinit", "lininit", "vsom",
        "qerror", "vcal", "visual", "vfind", "umat", "planes",
    ]:
        assert prog in names, prog


def test_lvq_pipeline_cli(ref_dir, golden_dir, tmp_path):
    os.chdir(tmp_path)
    rc, _ = run("eveninit", "-din", f"{ref_dir}/ex1.dat", "-cout", "e.cod", "-noc", 200)
    assert rc == 0
    assert open("e.cod").read() == open(f"{golden_dir}/lvq_e.cod").read()

    rc, out = run("balance", "-din", f"{ref_dir}/ex1.dat", "-cin", "e.cod", "-cout", "b.cod")
    assert rc == 0
    assert open("b.cod").read() == open(f"{golden_dir}/lvq_b.cod").read()
    assert open("b.lra").read() == open(f"{golden_dir}/lvq_b.lra").read()
    assert "units, min dist.:" in out

    rc, out = run("olvq1", "-din", f"{ref_dir}/ex1.dat", "-cin", "b.cod",
                  "-cout", "o.cod", "-rlen", 5000)
    assert rc == 0
    assert open("o.cod").read() == open(f"{golden_dir}/lvq_o.cod").read()
    # lvqtrain removes the freshly written .lra (lvqtrain.c:249)
    assert not os.path.exists("o.lra")
    assert "Removing the learning rate file" in out

    rc, out = run("accuracy", "-din", f"{ref_dir}/ex2.dat", "-cin", "o.cod",
                  "-cfout", "o.cfo")
    assert rc == 0
    assert "Total accuracy:  1962 entries  90.11 %" in out
    assert open("o.cfo").read() == open(f"{golden_dir}/lvq_o.cfo").read()


def test_som_pipeline_cli(ref_dir, golden_dir, tmp_path):
    os.chdir(tmp_path)
    rc, _ = run("randinit", "-din", f"{ref_dir}/ex.dat", "-cout", "r.cod",
                "-xdim", 12, "-ydim", 8, "-topol", "hexa", "-neigh", "bubble",
                "-rand", 123)
    assert rc == 0
    assert open("r.cod").read() == open(f"{golden_dir}/som_r.cod").read()

    rc, _ = run("vsom", "-din", f"{ref_dir}/ex.dat", "-cin", "r.cod",
                "-cout", "1.cod", "-rlen", 1000, "-alpha", 0.05, "-radius", 10)
    assert rc == 0
    assert open("1.cod").read() == open(f"{golden_dir}/som_1.cod").read()

    rc, _ = run("vsom", "-din", f"{ref_dir}/ex.dat", "-cin", "1.cod",
                "-cout", "2.cod", "-rlen", 10000, "-alpha", 0.02, "-radius", 3)
    assert rc == 0
    assert open("2.cod").read() == open(f"{golden_dir}/som_2.cod").read()

    rc, out = run("qerror", "-din", f"{ref_dir}/ex.dat", "-cin", "2.cod")
    assert rc == 0
    assert "3.571006 per sample (3840 samples)" in out

    rc, _ = run("vcal", "-din", f"{ref_dir}/ex_fts.dat", "-cin", "2.cod",
                "-cout", "v.cod")
    assert rc == 0
    assert open("v.cod").read() == open(f"{golden_dir}/som_v.cod").read()

    rc, _ = run("visual", "-din", f"{ref_dir}/ex_ndy.dat", "-cin", "v.cod",
                "-dout", "n.vis")
    assert rc == 0
    assert open("n.vis").read() == open(f"{golden_dir}/som_n.vis").read()


def test_qerror_quiet_mode(ref_dir, golden_dir, tmp_path):
    os.chdir(tmp_path)
    import shutil

    shutil.copy(f"{golden_dir}/som_2.cod", "2.cod")
    rc, out = run("qerror", "-din", f"{ref_dir}/ex.dat", "-cin", "2.cod", "-v", 0)
    assert rc == 0
    assert out == "3.571006\n"


def test_mcnemar_cli(golden_dir, tmp_path, capsys):
    rc = main(["mcnemar", f"{golden_dir}/lvq_o.cfo", f"{golden_dir}/lvq_b.cfo"])
    assert rc == 0
    err = capsys.readouterr().err
    assert err == open(f"{golden_dir}/mcnemar.txt").read()


def test_missing_required_flag_exits(ref_dir, capsys):
    rc = main(["qerror", "-din", f"{ref_dir}/ex.dat"])
    assert rc == 255
    assert "Can't find asked option -cin" in capsys.readouterr().err


def test_planes_cli(golden_dir, tmp_path):
    os.chdir(tmp_path)
    import shutil

    shutil.copy(f"{golden_dir}/som_v.cod", "v.cod")
    rc, _ = run("planes", "-cin", "v.cod", "-plane", 1, "-ps", 1)
    assert rc == 0
    assert open("v_p1.ps").read() == open(f"{golden_dir}/som_v_p1.ps").read()


def test_mapinit_extra_params_warning(ref_dir, tmp_path, capsys):
    os.chdir(tmp_path)
    rc = main(["randinit", "-din", f"{ref_dir}/ex.dat", "-cout", "r.cod",
               "-xdim", "4", "-ydim", "2", "-topol", "hexa", "-neigh",
               "bubble", "-bogus", "1"])
    assert rc == 0
    assert "Extra parameters in command line ignored" in capsys.readouterr().err


def test_vfind_cli(ref_dir, tmp_path):
    os.chdir(tmp_path)
    answers = "\n".join([
        "2",                      # trials
        f"{ref_dir}/ex.dat",      # data
        f"{ref_dir}/ex.dat",      # test
        "best.cod",               # out
        "hexa", "bubble",
        "4", "3",
        "100", "0.05", "4",
        "200", "0.02", "2",
    ]) + "\n"
    rc, out = run("vfind", stdin=answers)
    assert rc == 0
    assert os.path.exists("best.cod")
    assert "Smallest error with random seed" in out


def test_snapshot_file_type(ref_dir, golden_dir, tmp_path):
    os.chdir(tmp_path)
    import shutil

    shutil.copy(f"{golden_dir}/som_r.cod", "r.cod")
    rc, _ = run("vsom", "-din", f"{ref_dir}/ex.dat", "-cin", "r.cod",
                "-cout", "s.cod", "-rlen", 1000, "-alpha", 0.05, "-radius", 10,
                "-snapfile", "snap_%d.cod", "-snapinterval", 400)
    assert rc == 0
    assert os.path.exists("snap_400.cod")
    assert os.path.exists("snap_800.cod")
    txt = open("snap_400.cod").read()
    assert "#SNAPSHOT FILE" in txt
    assert "#iterations: 400/1000" in txt


def test_snapshot_keepopen(ref_dir, golden_dir, tmp_path):
    os.chdir(tmp_path)
    import shutil

    from som_lvq_pak_tpu.utils.snapshot import read_snapshots

    shutil.copy(f"{golden_dir}/som_r.cod", "r.cod")
    rc, _ = run("vsom", "-din", f"{ref_dir}/ex.dat", "-cin", "r.cod",
                "-cout", "s.cod", "-rlen", 1000, "-alpha", 0.05, "-radius", 10,
                "-snapfile", "snaps.cod", "-snapinterval", 250,
                "-snaptype", "keepopen")
    assert rc == 0
    snaps = read_snapshots("snaps.cod")
    assert len(snaps) == 3  # iterations 250, 500, 750
    assert all(s.n == 96 for s in snaps)


def test_lvq_run_interactive(ref_dir, tmp_path):
    """Full interactive lvq_run session: create a classifier with the
    lvqexample parameters (noc 200, one balance round, rlen 5000) and
    verify the same 90.11 % accuracy plus a reloadable .log state file
    (lvq_run.c:1020-1234)."""
    os.chdir(tmp_path)
    answers = "\n".join([
        "",                      # press enter to continue
        "1",                     # create new classifier
        f"{ref_dir}/ex1.dat",    # training data
        "200",                   # noc
        "",                      # init option (default even)
        "5000",                  # rlen
        f"{ref_dir}/ex2.dat",    # test data
        "c1",                    # classifier file base name
        "y",                     # one balance round
        "n",                     # stop balancing
        "0",                     # quit & save
    ]) + "\n"
    rc, out = run("lvq_run", stdin=answers)
    assert rc == 0
    assert "Total accuracy:  1962 entries  90.11 %" in out
    assert os.path.exists("c1.ini")
    assert os.path.exists("c1.cod")
    assert os.path.exists("c1.cfo")
    assert os.path.exists("c1.acc")
    assert os.path.exists("c1.log")

    from som_lvq_pak_tpu.cli.lvq_run import load_log

    c = load_log("c1")
    assert c.noc == 200
    assert c.totrlen == 5000
    assert abs(c.accuracy - 90.11) < 0.005
    assert any("olvq1" in h for h in c.history)


def test_lvq_run_pipeline_api(ref_dir, tmp_path):
    """The scriptable Pipeline API (no interactivity)."""
    os.chdir(tmp_path)
    import io as _io

    from som_lvq_pak_tpu.cli.lvq_run import Classifier, Pipeline, save_log

    c = Classifier(din=f"{ref_dir}/ex1.dat", tdin=f"{ref_dir}/ex2.dat",
                   cout="p1", noc=200, rlen=5000)
    pipe = Pipeline(out=_io.StringIO())
    pipe.init_classifier(c, balance_rounds=1)
    pipe.train_classifier(c)
    pipe.test_classifier(c)
    assert abs(c.accuracy - 90.11) < 0.005
    save_log(c)
    assert os.path.exists("p1.log")


def test_selfuncs_flag(ref_dir, golden_dir, tmp_path, capsys):
    """-selfuncs: only the "default" set exists (set_vector_functions,
    datafile.c:1222-1243); unknown names warn to stderr and fall back."""
    os.chdir(tmp_path)
    rc, out = run("qerror", "-din", f"{ref_dir}/ex.dat",
                  "-cin", f"{golden_dir}/som_g.cod", "-selfuncs", "default")
    assert rc == 0
    assert "not found" not in capsys.readouterr().err

    rc, out2 = run("qerror", "-din", f"{ref_dir}/ex.dat",
                   "-cin", f"{golden_dir}/som_g.cod", "-selfuncs", "fast")
    assert rc == 0
    assert out2 == out  # falls back to the default functions
    assert "functions for 'fast' not found, using defaults" in capsys.readouterr().err


def test_help_usage_blocks(capsys):
    """`somvq <tool> -help` prints the reference program's usage[] block
    byte-for-byte (printhelp(), lvq_pak.h:296; goldens captured from the
    compiled reference binaries)."""
    import som_lvq_pak_tpu.cli as cli

    here = os.path.dirname(os.path.abspath(__file__))
    for tool, golden in (("vsom", "vsom_help.txt"),
                         ("eveninit", "eveninit_help.txt")):
        rc = cli.main([tool, "-help"])
        assert rc == 0
        out = capsys.readouterr().out
        with open(os.path.join(here, "golden", golden)) as f:
            assert out == f.read()

    # every flag-based tool (and alias) has a usage block
    from som_lvq_pak_tpu.cli.usage import usage_text

    for tool in cli.tool_names():
        # mcnemar only prints usage on bad argc (mcnemar.c:61, stderr);
        # vfind is interactive with no usage[] at all
        if tool in ("mcnemar", "vfind"):
            assert usage_text(tool) is None
            continue
        assert usage_text(tool), f"missing usage text for {tool}"


def test_vfind_fast_flag_matches_selection(ref_dir, tmp_path):
    """-fast (extension) trains all trials at once on device; the
    per-trial qerrors must land near the sequential parity trials' and
    the output map must be a valid codebook of the requested shape."""
    os.chdir(tmp_path)
    answers = "\n".join([
        "3",                      # trials
        f"{ref_dir}/ex.dat",      # data
        f"{ref_dir}/ex.dat",      # test
        "best_fast.cod",          # out
        "hexa", "gaussian",
        "4", "3",
        "200", "0.05", "4",
        "300", "0.02", "2",
    ]) + "\n"
    rc, out = run("vfind", "-fast", stdin=answers)
    assert rc == 0
    assert os.path.exists("best_fast.cod")
    assert "Smallest error with random seed" in out

    from som_lvq_pak_tpu.data.io import read_data
    from som_lvq_pak_tpu.models import som as msom

    best = read_data("best_fast.cod")
    assert best.points.shape == (12, 5)
    assert best.xdim == 4 and best.ydim == 3

    # the fast winner must quantize the data about as well as the
    # sequential parity pipeline's winner at the same settings
    data = read_data(f"{ref_dir}/ex.dat")
    q_fast = msom.find_qerror(best, data, mode="fast") / data.n
    rc, out2 = run("vfind", stdin=answers.replace("best_fast", "best_par"))
    assert rc == 0
    best_par = read_data("best_par.cod")
    q_par = msom.find_qerror(best_par, data, mode="fast") / data.n
    assert q_fast < 1.3 * q_par, (q_fast, q_par)


def test_vfind_fast_degenerate_and_flag_fallback(ref_dir, tmp_path):
    """-fast with 0 trials exits cleanly writing nothing (parity
    behavior); -fast combined with -weights falls back to the
    sequential path rather than silently dropping the flag."""
    os.chdir(tmp_path)
    answers = "\n".join([
        "0", f"{ref_dir}/ex.dat", f"{ref_dir}/ex.dat", "zero.cod",
        "hexa", "bubble", "3", "2",
        "50", "0.05", "3", "50", "0.02", "2",
    ]) + "\n"
    rc, out = run("vfind", "-fast", stdin=answers)
    assert rc == 0
    assert not os.path.exists("zero.cod")

    answers2 = "\n".join([
        "1", f"{ref_dir}/ex.dat", f"{ref_dir}/ex.dat", "wf.cod",
        "hexa", "bubble", "3", "2",
        "60", "0.05", "3", "60", "0.02", "2",
    ]) + "\n"
    rc, _ = run("vfind", "-fast", "-weights", "1", stdin=answers2)
    assert rc == 0
    rc, _ = run("vfind", "-weights", "1",
                stdin=answers2.replace("wf.cod", "wp.cod"))
    assert rc == 0
    a = open("wf.cod").read()
    b = open("wp.cod").read()
    assert a == b  # fell back to the identical sequential path


def test_vsom_fast_extension(ref_dir, golden_dir, tmp_path):
    """`vsom -fast` (extension): minibatch training through SOMTrainer
    — map learns (qerror drops vs the init), full-load
    and streamed (-buffer) variants both run."""
    os.chdir(tmp_path)
    rc, _ = run("randinit", "-din", f"{ref_dir}/ex.dat", "-cout", "f0.cod",
                "-xdim", 12, "-ydim", 8, "-topol", "hexa", "-neigh",
                "gaussian", "-rand", 5)
    assert rc == 0
    rc, q0 = run("qerror", "-din", f"{ref_dir}/ex.dat", "-cin", "f0.cod",
                 "-fast", "-v", 0)
    rc, _ = run("vsom", "-din", f"{ref_dir}/ex.dat", "-cin", "f0.cod",
                "-cout", "f1.cod", "-rlen", 8000, "-alpha", 0.05,
                "-radius", 8, "-fast", "-batch", 256)
    assert rc == 0
    rc, q1 = run("qerror", "-din", f"{ref_dir}/ex.dat", "-cin", "f1.cod",
                 "-fast", "-v", 0)
    assert float(q1) < float(q0), (q0, q1)
    rc, _ = run("vsom", "-din", f"{ref_dir}/ex.dat", "-cin", "f0.cod",
                "-cout", "f2.cod", "-rlen", 4000, "-alpha", 0.05,
                "-radius", 8, "-fast", "-batch", 256, "-buffer", 600)
    assert rc == 0
    rc, q2 = run("qerror", "-din", f"{ref_dir}/ex.dat", "-cin", "f2.cod",
                 "-fast", "-v", 0)
    assert float(q2) < float(q0), (q0, q2)


def test_lvqtrain_fast_extension(ref_dir, golden_dir, tmp_path):
    """`olvq1/lvq3 -fast` (extension): minibatch device training from
    the CLI keeps the golden pipeline's accuracy level."""
    os.chdir(tmp_path)
    with open(f"{golden_dir}/lvq_b.cod") as f:
        open("fb.cod", "w").write(f.read())
    rc, _ = run("olvq1", "-din", f"{ref_dir}/ex1.dat", "-cin", "fb.cod",
                "-cout", "fo.cod", "-rlen", 5000, "-fast", "-batch", 64)
    assert rc == 0
    rc, out = run("accuracy", "-din", f"{ref_dir}/ex2.dat", "-cin", "fo.cod")
    assert rc == 0
    pct = float(out.strip().splitlines()[-1].split()[-2])
    assert pct > 88.0, out  # golden pipeline is 90.11 %
    # lvq3 -fast with a streamed -buffer feed
    rc, _ = run("lvq3", "-din", f"{ref_dir}/ex1.dat", "-cin", "fo.cod",
                "-cout", "f3.cod", "-rlen", 2000, "-alpha", 0.05,
                "-win", 0.3, "-epsilon", 0.1, "-fast", "-batch", 64,
                "-buffer", 500)
    assert rc == 0
    rc, out = run("accuracy", "-din", f"{ref_dir}/ex2.dat", "-cin", "f3.cod")
    assert rc == 0
    pct = float(out.strip().splitlines()[-1].split()[-2])
    assert pct > 88.0, out
