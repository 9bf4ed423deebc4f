"""Worker process for tests/test_multihost.py.

Run as:  python multihost_worker.py <coordinator> <pid> <nprocs> <datafile> <outdir>

Each process owns 4 virtual CPU devices (8 global over 2 processes),
initializes jax.distributed, streams ITS OWN half of the data file
(StreamingReader shard=(pid, nprocs) — the multi-host input pipeline),
assembles the global batch with make_array_from_process_local_data, and
runs one sharded SOM step and one sharded olvq1 step over the global
(data, model) mesh.  Process 0 writes the gathered results for the
parent test to compare against the single-process oracle.
"""

import os
import sys


def main() -> int:
    coordinator, pid, nprocs, datafile, outdir = sys.argv[1:6]
    pid, nprocs = int(pid), int(nprocs)

    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=nprocs, process_id=pid
    )
    assert jax.process_count() == nprocs
    assert len(jax.devices()) == 4 * nprocs, len(jax.devices())

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from som_lvq_pak_tpu.data.streaming import StreamingReader
    from som_lvq_pak_tpu.models.fast import som_batch_step, unit_coords
    from som_lvq_pak_tpu.parallel.mesh import make_mesh
    from som_lvq_pak_tpu.parallel.sharded import (
        make_sharded_olvq1_train_step,
        make_sharded_som_train_step,
        shard_arrays,
    )

    mesh = make_mesh(8, data=nprocs, model=8 // nprocs)

    # --- host-sharded input pipeline: this process streams rows
    # pid, pid+nprocs, ... of the shared file (DCN-storage analogue)
    reader = StreamingReader(datafile, buffer=16, shard=(pid, nprocs))
    chunks = list(reader.chunks(laps=1))
    local = np.concatenate([c.points for c in chunks])
    local_labels = np.concatenate([c.first_labels() for c in chunks])

    B = local.shape[0] * nprocs
    D = local.shape[1]

    # deterministic codebook, same on every process
    rng = np.random.RandomState(5)
    N = 16 * 4
    codes = rng.randn(N, D).astype(np.float32)
    clabels = (np.arange(N) % 3 + 1).astype(np.int32)
    coords = unit_coords(16, 4, hexa=True)

    # --- global batch from per-process shards
    xs = multihost_utils.host_local_array_to_global_array(
        local, mesh, P("data", None)
    )
    xl = multihost_utils.host_local_array_to_global_array(
        local_labels, mesh, P("data")
    )

    # --- sharded SOM step
    som_step = make_sharded_som_train_step(mesh, gaussian=False, xdim=16,
                                           hexa=True)
    cs, _ = shard_arrays(mesh, jnp.asarray(codes), jnp.zeros((B, D)))
    out = som_step(cs, xs, jnp.float32(0.05), jnp.float32(3.0))
    som_result = multihost_utils.process_allgather(out, tiled=True)

    # --- sharded olvq1 step
    lvq_step = make_sharded_olvq1_train_step(mesh)
    alphas = jnp.full((N,), 0.3, dtype=jnp.float32)
    oc, oa = lvq_step(
        jax.device_put(jnp.asarray(codes), NamedSharding(mesh, P("model", None))),
        jnp.asarray(clabels), alphas, xs, xl,
    )
    lvq_codes = multihost_utils.process_allgather(oc, tiled=True)
    lvq_alphas = multihost_utils.process_allgather(oa, tiled=True)

    # the global batch in device order, for the parent's oracle
    xb_global = multihost_utils.process_allgather(xs, tiled=True)
    xl_global = multihost_utils.process_allgather(xl, tiled=True)

    # --- multi-step streamed train with a MID-RUN CHECKPOINT RESUME:
    # each step trains on a rotated slice of this process's stream shard
    # (a fresh global batch per step); halfway through, process 0
    # persists the codebook (the gathered global view) and every process
    # restores from that file and finishes — the resumed run must equal
    # the uninterrupted one bit-for-bit.
    from som_lvq_pak_tpu.utils.checkpoint import Checkpointer, TrainState

    K = 6

    def global_batch(t):
        loc = np.roll(local, t * 7, axis=0)
        return multihost_utils.host_local_array_to_global_array(
            loc, mesh, P("data", None)
        )

    def advance(state, t0, t1):
        for t in range(t0, t1):
            a = jnp.float32(0.05 * (K - t) / K)
            r = jnp.float32(1.0 + 2.0 * (K - t) / K)
            state = som_step(state, global_batch(t), a, r)
        return state

    full = advance(cs, 0, K)
    full_g = multihost_utils.process_allgather(full, tiled=True)

    ckdir = os.path.join(outdir, "mh_ck")
    half = advance(cs, 0, K // 2)
    half_g = multihost_utils.process_allgather(half, tiled=True)
    if pid == 0:
        Checkpointer(ckdir).save(
            TrainState(codes=np.asarray(half_g), step=K // 2))
    multihost_utils.sync_global_devices("ckpt written")
    st = Checkpointer(ckdir).load()
    assert st is not None and st.step == K // 2, "all-restore failed"
    restored = jax.device_put(
        jnp.asarray(st.codes), NamedSharding(mesh, P("model", None)))
    resumed = advance(restored, K // 2, K)
    resumed_g = multihost_utils.process_allgather(resumed, tiled=True)
    np.testing.assert_allclose(
        np.asarray(resumed_g), np.asarray(full_g), rtol=1e-6, atol=1e-6)

    # --- model-only 8-shard mesh spanning both processes (the default
    # layout): the gaussian step must equal the single-device step every
    # process computes locally
    mesh_tp = make_mesh(8, data=1, model=8)
    tp_step = make_sharded_som_train_step(mesh_tp, gaussian=True, xdim=16,
                                          hexa=True)
    xb_full = jnp.asarray(xb_global)
    c_1d = som_batch_step(jnp.asarray(codes), xb_full, coords,
                          jnp.float32(0.05), jnp.float32(3.0), gaussian=True,
                          xdim=16, hexa=True)
    c_tp = tp_step(
        jax.device_put(jnp.asarray(codes), NamedSharding(mesh_tp, P("model", None))),
        xb_full, jnp.float32(0.05), jnp.float32(3.0))
    c_tp_g = multihost_utils.process_allgather(c_tp, tiled=True)
    np.testing.assert_allclose(np.asarray(c_tp_g), np.asarray(c_1d),
                               rtol=1e-5, atol=1e-5)

    if pid == 0:
        np.savez(
            os.path.join(outdir, "result.npz"),
            som=np.asarray(som_result),
            lvq_codes=np.asarray(lvq_codes),
            lvq_alphas=np.asarray(lvq_alphas),
            xb=np.asarray(xb_global),
            xl=np.asarray(xl_global),
            codes=codes,
            clabels=clabels,
            multi_full=np.asarray(full_g),
            multi_resumed=np.asarray(resumed_g),
            tp_ok=np.asarray(True),
        )
    multihost_utils.sync_global_devices("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
