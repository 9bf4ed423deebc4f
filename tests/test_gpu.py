"""Tests that need an NVIDIA GPU (marker `gpu`; skip elsewhere).

conftest pins this process to the CPU, so each test runs its device work
in a child process that owns the card:

    python -m pytest tests/ -m gpu
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")
    r = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if r.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("JAX finds no GPU")
    env["PYTHONPATH"] = REPO
    return env


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1000, 4100, 20), (4096, 65536, 64)])
def test_winner_kernel_compiled_matches_reference(gpu_env, shape):
    """The Triton winner kernel, compiled for the card, picks the same
    top-1 and top-2 rows as the XLA search at precision='highest'."""
    code = f"""
import jax, jax.numpy as jnp, numpy as np
from som_lvq_pak_tpu.ops.distance import topk_winners
from som_lvq_pak_tpu.ops.triton_winner import winner_topk
B, N, D = {shape}
k1, k2 = jax.random.split(jax.random.PRNGKey(0))
x = jax.random.normal(k1, (B, D)) * 3
m = jax.random.normal(k2, (N, D)) * 3
for k in (1, 2):
    got = np.asarray(winner_topk(x, m, k=k)[0])
    ref = np.asarray(topk_winners(x, m, k)[0])
    assert (got == ref).all(axis=1).mean() >= 0.999, k
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", code], env=gpu_env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "OK"
