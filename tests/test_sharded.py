"""Sharded winner search + SOM step on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from som_lvq_pak_tpu.models.fast import som_batch_step, unit_coords
from som_lvq_pak_tpu.parallel.mesh import make_mesh
from som_lvq_pak_tpu.parallel.sharded import make_sharded_som_train_step, shard_arrays


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    # a mixed data x model mesh: both collectives run
    return make_mesh(8, data=2, model=4)


def test_mesh_factorization(mesh):
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("data", "model")
    # the default layout puts every device on the model axis
    assert dict(make_mesh(8).shape) == {"data": 1, "model": 8}


def test_sharded_matches_single_device(mesh):
    B, N, D = 64, 16 * 8, 16
    xdim, ydim = 16, 8
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    codes = jax.random.normal(k1, (N, D), dtype=jnp.float32)
    xb = jax.random.normal(k2, (B, D), dtype=jnp.float32) * 2
    coords = unit_coords(xdim, ydim, hexa=True)

    ref = som_batch_step(codes, xb, coords, 0.05, 3.0, gaussian=False,
                         update="sum", xdim=xdim, hexa=True)

    step = make_sharded_som_train_step(mesh, gaussian=False, xdim=xdim,
                                       hexa=True)
    cs, xs = shard_arrays(mesh, codes, xb)
    out = step(cs, xs, jnp.float32(0.05), jnp.float32(3.0))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_sharded_gaussian(mesh):
    B, N, D = 32, 64, 8
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    codes = jax.random.normal(k1, (N, D), dtype=jnp.float32)
    xb = jax.random.normal(k2, (B, D), dtype=jnp.float32)
    coords = unit_coords(8, 8, hexa=False)
    ref = som_batch_step(codes, xb, coords, 0.02, 2.0, gaussian=True,
                         update="sum", xdim=8, hexa=False)
    step = make_sharded_som_train_step(mesh, gaussian=True, xdim=8, hexa=False)
    out = step(*shard_arrays(mesh, codes, xb), jnp.float32(0.02), jnp.float32(2.0))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_sharded_olvq1_matches_batch_step(mesh):
    from som_lvq_pak_tpu.models.fast import olvq1_batch_step
    from som_lvq_pak_tpu.parallel.sharded import make_sharded_olvq1_train_step

    B, N, D = 64, 16 * 8, 16
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(7), 4)
    codes = jax.random.normal(k1, (N, D), dtype=jnp.float32)
    xb = jax.random.normal(k2, (B, D), dtype=jnp.float32) * 2
    clabels = jax.random.randint(k3, (N,), 1, 5)
    xlabels = jax.random.randint(k4, (B,), 1, 5)
    alphas = jnp.full((N,), 0.3, dtype=jnp.float32)

    ref_codes, ref_a = olvq1_batch_step(codes, clabels, alphas, xb, xlabels)
    step = make_sharded_olvq1_train_step(mesh)
    from jax.sharding import NamedSharding, PartitionSpec as P

    cs = jax.device_put(codes, NamedSharding(mesh, P("model", None)))
    xs = jax.device_put(xb, NamedSharding(mesh, P("data", None)))
    xl = jax.device_put(xlabels, NamedSharding(mesh, P("data")))
    out_codes, out_a = step(cs, clabels, alphas, xs, xl)
    np.testing.assert_allclose(np.asarray(out_codes), np.asarray(ref_codes),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_a), np.asarray(ref_a),
                               rtol=1e-6, atol=1e-6)


def test_dim_sharded_winner_search(mesh):
    from som_lvq_pak_tpu.ops.distance import find_winners
    from som_lvq_pak_tpu.parallel.sharded import make_dim_sharded_winner

    B, N, D = 32, 64, 32  # D divides the 4-wide model axis
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    codes = jax.random.normal(k1, (N, D), dtype=jnp.float32)
    xb = jax.random.normal(k2, (B, D), dtype=jnp.float32) * 3
    ref_idx, _ = find_winners(xb, codes)

    winner = make_dim_sharded_winner(mesh)
    val, idx = winner(xb, codes)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref_idx))


def test_class_blocked_olvq1_matches_unsharded(mesh):
    """EP layout: class-blocked sharded olvq1 == plain batch step modulo
    the row permutation, and each class's rows span a minimal shard set."""
    from som_lvq_pak_tpu.models.fast import olvq1_batch_step
    from som_lvq_pak_tpu.parallel.sharded import ClassBlockedOLVQ1

    B, N, D = 64, 16 * 8, 16
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(21), 4)
    codes = jax.random.normal(k1, (N, D), dtype=jnp.float32)
    xb = jax.random.normal(k2, (B, D), dtype=jnp.float32) * 2
    clabels = jax.random.randint(k3, (N,), 1, 5)
    xlabels = jax.random.randint(k4, (B,), 1, 5)
    alphas = jnp.full((N,), 0.3, dtype=jnp.float32)

    ref_codes, ref_a = olvq1_batch_step(codes, clabels, alphas, xb, xlabels)
    ep = ClassBlockedOLVQ1(mesh, codes, clabels)
    ep.step(xb, xlabels)
    np.testing.assert_allclose(np.asarray(ep.codes()), np.asarray(ref_codes),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ep.alphas()), np.asarray(ref_a),
                               rtol=1e-6, atol=1e-6)

    # layout property: a class with k rows can span at most
    # ceil(k / rows_per_shard) + 1 shards when blocked (vs up to S when
    # scattered); verify the blocked bound holds for every class
    s = mesh.shape["model"]
    per = -(-N // s)
    counts = {int(c): int((np.asarray(clabels) == c).sum())
              for c in np.unique(np.asarray(clabels))}
    for c, nsh in ep.shards_per_class().items():
        assert nsh <= -(-counts[c] // per) + 1, (c, nsh, counts[c])


def test_overlap_chunked_step_matches_unchunked(mesh):
    """Collective/compute-pipelined step (batch split so each chunk's
    winner all_gather overlaps the next chunk's matmul) == plain step."""
    B, N, D = 64, 16 * 8, 16
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    codes = jax.random.normal(k1, (N, D), dtype=jnp.float32)
    xb = jax.random.normal(k2, (B, D), dtype=jnp.float32) * 2
    plain = make_sharded_som_train_step(mesh, gaussian=True, xdim=16,
                                        hexa=True)
    lapped = make_sharded_som_train_step(mesh, gaussian=True, xdim=16,
                                         hexa=True, overlap_chunks=4)
    args = shard_arrays(mesh, codes, xb)
    a = plain(*args, jnp.float32(0.05), jnp.float32(3.0))
    b = lapped(*args, jnp.float32(0.05), jnp.float32(3.0))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_ring_winner_search_matches_reference(mesh):
    """Ring-pass winner search (codebook shards circulating via ppermute,
    batch never replicated) == the single-device exact argmin, including
    first-index tie-breaks on duplicated codes."""
    from som_lvq_pak_tpu.parallel.sharded import make_ring_winner

    B, N, D = 64, 16 * 8, 16
    k1, k2 = jax.random.split(jax.random.PRNGKey(13))
    codes = jax.random.normal(k1, (N, D), dtype=jnp.float32)
    # duplicate a few rows to force exact distance ties
    codes = codes.at[100].set(codes[3]).at[77].set(codes[5])
    xb = jax.random.normal(k2, (B, D), dtype=jnp.float32) * 2

    from som_lvq_pak_tpu.ops.distance import find_winners

    ref_idx, ref_val = find_winners(xb, codes)
    winner = make_ring_winner(mesh)
    val, idx = winner(xb, codes)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref_idx))
    np.testing.assert_allclose(np.asarray(val), np.asarray(ref_val),
                               rtol=1e-5, atol=1e-4)


def test_dim_sharded_winner_search_large_codebook(mesh):
    """SP path at the BASELINE 65k-codebook scale: the tiled scan must
    run within memory (never materializing (B, 65536)) and agree with
    the exact argmin."""
    from som_lvq_pak_tpu.ops.distance import find_winners
    from som_lvq_pak_tpu.parallel.sharded import make_dim_sharded_winner

    B, N, D = 16, 65536, 32
    k1, k2 = jax.random.split(jax.random.PRNGKey(17))
    codes = jax.random.normal(k1, (N, D), dtype=jnp.float32)
    xb = jax.random.normal(k2, (B, D), dtype=jnp.float32) * 3
    ref_idx, _ = find_winners(xb, codes)

    winner = make_dim_sharded_winner(mesh, chunk=2048)
    _, idx = winner(xb, codes)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref_idx))


@pytest.mark.parametrize("algorithm", ["lvq1", "lvq2", "lvq3"])
def test_sharded_lvq_step_matches_batch_step(mesh, algorithm):
    """Sharded fixed-alpha LVQ steps equal the single-device batched
    steps (models.fast.lvq1_batch_step / lvq23_batch_step)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from som_lvq_pak_tpu.models.fast import lvq1_batch_step, lvq23_batch_step
    from som_lvq_pak_tpu.parallel.sharded import make_sharded_lvq_train_step

    B, N, D = 64, 16 * 8, 16
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(21), 4)
    codes = jax.random.normal(k1, (N, D), dtype=jnp.float32)
    clab = jax.random.randint(k2, (N,), 1, 5)
    xb = jax.random.normal(k3, (B, D), dtype=jnp.float32) * 2
    xlab = jax.random.randint(k4, (B,), 1, 5)
    alpha = jnp.float32(0.05)

    if algorithm == "lvq1":
        ref = lvq1_batch_step(codes, clab, xb, xlab, alpha)
    else:
        ref = lvq23_batch_step(codes, clab, xb, xlab, alpha, 0.3,
                               epsilon=0.1, lvq3=(algorithm == "lvq3"))

    step = make_sharded_lvq_train_step(mesh, algorithm=algorithm,
                                       winlen=0.3, epsilon=0.1)
    out = step(
        jax.device_put(codes, NamedSharding(mesh, P("model", None))),
        clab,
        jax.device_put(xb, NamedSharding(mesh, P("data", None))),
        jax.device_put(xlab, NamedSharding(mesh, P("data"))),
        alpha,
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dd,dm", [(2, 4), (1, 8)])
def test_mesh_trainer_weighted_fixed_masked_matches_single(dd, dm):
    """SOMTrainer on a mesh must equal the single-device trainer for
    data carrying weight= / fixed= tokens (the effective-alpha fold and
    the BMU override) AND for masked data (the masked sharded step)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
    from som_lvq_pak_tpu.models.trainer import SOMTrainer

    rng = np.random.default_rng(5)
    N_DATA, D = 256, 16
    xdim, ydim = 16, 8
    X = rng.normal(0, 1, size=(N_DATA, D)).astype(np.float32)
    weight = rng.integers(0, 4, size=N_DATA).astype(np.float32)  # 0=absent
    fixed = np.full((N_DATA, 2), -1, np.int32)
    fixed[::7] = [3, 2]  # every 7th sample pinned to unit (3, 2)
    codes0 = Dataset(
        points=rng.normal(0, 1, size=(xdim * ydim, D)).astype(np.float32),
        topol=Topology.HEXA, neigh=Neighborhood.GAUSSIAN,
        xdim=xdim, ydim=ydim)

    def run(mesh, ds):
        tr = SOMTrainer(codes0, batch_size=64, mesh=mesh, seed=3)
        return tr.fit(ds, rlen=256, alpha=0.05, radius=4.0,
                      use_weights=True, use_fixed=True).points

    mesh = make_mesh(8, data=dd, model=dm)
    ds_wf = Dataset(points=X, weight=weight, fixed=fixed)
    np.testing.assert_allclose(
        run(mesh, ds_wf), run(None, ds_wf), rtol=1e-4, atol=1e-4)

    mask = np.zeros((N_DATA, D), np.uint8)
    mask[::5, 3] = 1
    ds_mask = Dataset(points=X, mask=mask)
    np.testing.assert_allclose(
        run(mesh, ds_mask), run(None, ds_mask), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dd,dm", [(1, 4), (2, 2), (4, 1)])
def test_som_trainer_four_device_meshes_match_single(dd, dm):
    """SOMTrainer on each layout of four devices (pure model parallel,
    mixed, pure data parallel) trains the same map as one device."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
    from som_lvq_pak_tpu.models.trainer import SOMTrainer

    rng = np.random.default_rng(11)
    X = rng.normal(0, 2, size=(512, 8)).astype(np.float32)
    codes0 = Dataset(
        points=rng.normal(0, 1, size=(16 * 8, 8)).astype(np.float32),
        topol=Topology.HEXA, neigh=Neighborhood.GAUSSIAN, xdim=16, ydim=8)

    def run(mesh):
        tr = SOMTrainer(codes0, batch_size=64, mesh=mesh, seed=1)
        return tr.fit(Dataset(points=X), rlen=1024, alpha=0.05,
                      radius=5.0).points

    got = run(make_mesh(4, data=dd, model=dm))
    np.testing.assert_allclose(got, run(None), rtol=1e-4, atol=1e-4)
