"""chip_smoke.py's phases at tiny sizes on the CPU, its refusals, the
compile-cache placement, and that no fast path loads a TPU module."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = {
    "ops": lambda: chip_smoke.phase_ops(0, "cpu", B=64, xdim=16, ydim=8, d=8),
    "a": lambda: chip_smoke.phase_a(0, "cpu", n=4096, xdim=16, ydim=8, d=8,
                                    batch=256, chunk=1024, radius=4.0),
    "b": lambda: chip_smoke.phase_b(0, "cpu", n=2048, xdim=8, ydim=6, d=8,
                                    buffer=512),
    "c": lambda: chip_smoke.phase_c(0, "cpu", noc=20, d=8, classes=4,
                                    n_train=2000, n_test=500, batch=256),
}


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_tiny(phase):
    out = TINY[phase]()
    assert isinstance(out, dict) and out


def test_phase_d_four_virtual_devices():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    out = chip_smoke.phase_d(0, "cpu", steps=4, xdim=16, ydim=8, d=8, batch=64)
    assert set(out) == {"mesh_1x4", "mesh_2x2"}


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_refuses_alone_in_directory(tmp_path):
    """With a GPU but without the rest of the repository the script fails
    before it prints a result (the GPU is faked: only the import can
    fail)."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    code = (
        "import sys, types, runpy, jax\n"
        "fake = types.SimpleNamespace(platform='gpu', device_kind='fake')\n"
        "jax.devices = lambda *a: [fake]\n"
        "sys.argv = ['chip_smoke.py']\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "som_lvq_pak_tpu" in r.stderr
    assert '"ok"' not in r.stdout


def _cache_dir(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("from som_lvq_pak_tpu.utils.compile_cache import enable_compile_cache\n"
            "p = enable_compile_cache()\n"
            "import jax\n"
            "print(p, jax.config.jax_compilation_cache_dir)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300, check=True)
    return r.stdout.split()


@pytest.mark.parametrize("env_value", [None, "/somewhere/else"],
                         ids=["unset", "set"])
def test_compile_cache_placement(env_value):
    got = _cache_dir(env_value)
    want = env_value or os.path.join(REPO, ".jax_cache")
    assert got == [want, want]


def test_fast_paths_load_no_tpu_module(tmp_path):
    """vsom -fast, qerror -fast and olvq1 -fast on tiny data never import
    jax.experimental.pallas.tpu."""
    code = r"""
import sys
import numpy as np
from som_lvq_pak_tpu import cli
from som_lvq_pak_tpu.data.dataset import Dataset
from som_lvq_pak_tpu.data.io import write_data
from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS
rng = np.random.default_rng(0)
X = rng.normal(size=(600, 5)).astype(np.float32)
lab = np.asarray([GLOBAL_LABELS.to_index(f"c{i}") for i in range(3)])
write_data(Dataset(points=X, labels=lab[np.arange(600) % 3][:, None]), "d.dat")
def run(*a):
    assert cli.main([str(x) for x in a]) == 0, a
run("randinit", "-din", "d.dat", "-cout", "m0.cod", "-xdim", 6, "-ydim", 4,
    "-topol", "hexa", "-neigh", "gaussian", "-rand", 1)
run("vsom", "-din", "d.dat", "-cin", "m0.cod", "-cout", "m1.cod", "-fast",
    "-rlen", 600, "-alpha", 0.05, "-radius", 3, "-batch", 64)
run("qerror", "-din", "d.dat", "-cin", "m1.cod", "-fast")
run("eveninit", "-din", "d.dat", "-cout", "l0.cod", "-noc", 12)
run("olvq1", "-din", "d.dat", "-cin", "l0.cod", "-cout", "l1.cod", "-fast",
    "-rlen", 600)
print("TPU" if "jax.experimental.pallas.tpu" in sys.modules else "CLEAN")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "CLEAN"
