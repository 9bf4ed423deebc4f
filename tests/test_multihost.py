"""Real N=2-process jax.distributed test (SURVEY.md §4 implication d).

Spawns two actual Python processes, each owning 4 virtual CPU devices,
joined through jax.distributed into one 8-device (data=2, model=4) mesh.
Each process streams its own half of a shared data file
(StreamingReader shard=(k, 2) — the multi-host input pipeline), and the
pair execute the sharded SOM and olvq1 steps with cross-process
collectives.  Results must equal the single-process batch steps."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed(tmp_path):
    # shared input file: 128 x 12-dim labeled vectors
    rng = np.random.RandomState(11)
    n, dim = 128, 12
    pts = rng.randn(n, dim).astype(np.float32)
    labs = rng.randint(1, 4, n)
    datafile = tmp_path / "mh.dat"
    with open(datafile, "w") as f:
        f.write(f"{dim}\n")
        for row, lab in zip(pts, labs):
            f.write(" ".join(f"{v:.6f}" for v in row) + f" L{lab}\n")

    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own 4-device flag
    env["JAX_PLATFORMS"] = "cpu"
    worker = os.path.join(HERE, "multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coordinator, str(pid), "2",
             str(datafile), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"

    data = np.load(tmp_path / "result.npz")

    # single-process oracle on the exact global batch the pair assembled
    import jax.numpy as jnp

    from som_lvq_pak_tpu.models.fast import (
        olvq1_batch_step,
        som_batch_step,
        unit_coords,
    )

    coords = unit_coords(16, 4, hexa=True)
    ref_som = som_batch_step(
        jnp.asarray(data["codes"]), jnp.asarray(data["xb"]), coords,
        0.05, 3.0, gaussian=False, xdim=16, hexa=True,
    )
    np.testing.assert_allclose(data["som"], np.asarray(ref_som),
                               rtol=1e-5, atol=1e-5)

    ref_codes, ref_a = olvq1_batch_step(
        jnp.asarray(data["codes"]), jnp.asarray(data["clabels"]),
        jnp.full((data["codes"].shape[0],), 0.3, dtype=jnp.float32),
        jnp.asarray(data["xb"]), jnp.asarray(data["xl"]),
    )
    np.testing.assert_allclose(data["lvq_codes"], np.asarray(ref_codes),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(data["lvq_alphas"], np.asarray(ref_a),
                               rtol=1e-6, atol=1e-6)

    # the two halves of the stream really interleaved the file
    assert data["xb"].shape[0] == n
    got = np.sort(data["xb"][:, 0])
    # atol for the %.6f text round-trip of the shared file
    np.testing.assert_allclose(got, np.sort(pts[:, 0]), rtol=1e-5, atol=1e-5)

    # multi-step streamed run with mid-run checkpoint: process 0 wrote
    # the half-way state, both processes restored it, and the resumed
    # run reproduced the uninterrupted one (the workers assert equality
    # in-process too; this re-checks the artifacts cross-process)
    assert os.path.exists(tmp_path / "mh_ck")
    np.testing.assert_allclose(data["multi_resumed"], data["multi_full"],
                               rtol=1e-6, atol=1e-6)
    assert not np.allclose(data["multi_full"], data["codes"])  # it trained
