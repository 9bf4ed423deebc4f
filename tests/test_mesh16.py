"""16- and 32-device mesh validation.

The in-process suite runs on an 8-device virtual mesh (conftest); shape
assumptions that happen to hold at 8 (shard heights, batch % data-axis)
can still break at 16/32.  These tests run the full `dryrun_multichip`
sweep (every sharded path incl. the mixed data x model step, the pure
model-parallel step, sharded lvq3, and mesh checkpoint resume) in
subprocesses with 16 (mesh 2 x 8) and 32 (mesh 2 x 16) virtual
devices."""

import os
import subprocess
import sys

import pytest


@pytest.mark.parametrize("n_devices", [16, 32])
def test_dryrun_multichip_16_devices(n_devices):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_devices}")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms', 'cpu'); "
         "import __graft_entry__ as g; "
         f"g.dryrun_multichip({n_devices}); print('OKN')"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "OKN" in r.stdout
