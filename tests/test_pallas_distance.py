"""The Pallas-Triton winner kernel against the XLA reference (CPU
interpret mode), its CUDA lowering, ops.dispatch's choice of
implementation, and the XLA update op."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from som_lvq_pak_tpu.ops import dispatch
from som_lvq_pak_tpu.ops.distance import find_winners, topk_winners
from som_lvq_pak_tpu.ops.triton_winner import winner_topk

winner = functools.partial(winner_topk, interpret=True)

# unaligned B and N at every padded width of the kernel (16, 32, 64, 128)
SHAPES = [(37, 300, 5), (100, 200, 20), (256, 1030, 64), (50, 70, 100)]


def _data(shape, seed):
    B, N, D = shape
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    x = jax.random.normal(k1, (B, D), dtype=jnp.float32) * 10
    m = jax.random.normal(k2, (N, D), dtype=jnp.float32) * 10
    return x, m


@pytest.mark.parametrize("shape", SHAPES)
def test_dist_argmin_matches_reference(shape):
    x, m = _data(shape, 0)
    idx, val = winner(x, m, k=1)
    ridx, rval = find_winners(x, m)
    np.testing.assert_array_equal(np.asarray(idx[:, 0]), np.asarray(ridx))
    np.testing.assert_allclose(np.asarray(val[:, 0]), np.asarray(rval),
                               rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("shape", SHAPES)
def test_dist_top2_matches_oracle(shape):
    x, m = _data(shape, 1)
    idx, val = winner(x, m, k=2)
    ridx, rval = topk_winners(x, m, 2)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ridx))
    np.testing.assert_allclose(np.asarray(val), np.asarray(rval),
                               rtol=1e-4, atol=1e-2)


def test_tie_break_first_index():
    # duplicate codes: the lower index must win (C strict < scan)
    x = jnp.ones((8, 8), dtype=jnp.float32)
    m = jnp.tile(jnp.arange(4, dtype=jnp.float32)[:, None] % 2, (1, 8))
    m = jnp.concatenate([m, m], axis=0)  # rows 0..3 duplicated at 4..7
    idx, _ = winner(x, m, k=1)
    assert (np.asarray(idx[:, 0]) == 1).all()  # row 1 (all ones) wins
    idx2, _ = winner(x, m, k=2)
    assert np.asarray(idx2).tolist() == [[1, 3]] * 8


def test_tie_break_across_tiles_and_splits():
    """Exact duplicates far apart land in different codebook tiles and
    splits; the lower index still wins, for top-1 and top-2."""
    m = jax.random.normal(jax.random.PRNGKey(2), (2048, 16), dtype=jnp.float32)
    m = m.at[1900].set(m[3]).at[1000].set(m[7]).at[1500].set(m[3])
    x = m[jnp.array([3, 7, 3, 7])]
    idx, _ = winner(x, m, k=1, block_b=16, block_n=16)
    assert np.asarray(idx[:, 0]).tolist() == [3, 7, 3, 7]
    idx2, _ = winner(x, m, k=2, block_b=16, block_n=16)
    assert np.asarray(idx2).tolist() == [[3, 1500], [7, 1000],
                                         [3, 1500], [7, 1000]]


def test_unaligned_shapes():
    B, N, D = 7, 130, 3
    x, m = _data((B, N, D), 1)
    idx, val = winner(x, m, k=1)
    ridx, rval = find_winners(x, m)
    np.testing.assert_array_equal(np.asarray(idx[:, 0]), np.asarray(ridx))
    np.testing.assert_allclose(np.asarray(val[:, 0]), np.asarray(rval),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("gaussian", [False, True], ids=["bubble", "gaussian"])
@pytest.mark.parametrize("hexa", [True, False], ids=["hexa", "rect"])
def test_som_neighborhood_update_matches_xla(gaussian, hexa):
    """The update op (grid distances from BMU indices) equals the update
    built from the unit coordinate table (models.fast.neighborhood_matrix),
    with per-sample alphas."""
    from som_lvq_pak_tpu.models.fast import neighborhood_matrix, unit_coords

    for B, xdim, ydim, D in ((64, 16, 8, 5), (100, 20, 10, 33)):
        noc = xdim * ydim
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(B + gaussian), 3)
        codes = jax.random.normal(k1, (noc, D), dtype=jnp.float32)
        xb = jax.random.normal(k2, (B, D), dtype=jnp.float32) * 2
        bmu = jax.random.randint(k3, (B,), 0, noc)
        a = jnp.linspace(0.01, 0.08, B, dtype=jnp.float32)
        # 2.7: no grid distance of either lattice lies on the boundary
        W = neighborhood_matrix(unit_coords(xdim, ydim, hexa), bmu, 2.7, a,
                                gaussian)
        with jax.default_matmul_precision("highest"):
            ref = dispatch.guarded_blend(codes, W.T @ xb,
                                         W.sum(axis=0)[:, None])
            out = dispatch.som_update(codes, xb, bmu, a, 2.7, xdim=xdim,
                                      hexa=hexa, gaussian=gaussian)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


def test_som_accumulate_unit_offset_matches_xla():
    """Accumulators for a model shard (rows offset..offset+n) equal those
    rows of the whole-codebook accumulators, as the sharded step uses
    them."""
    xdim, noc, D, B = 16, 128, 7, 40
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    xb = jax.random.normal(k1, (B, D), dtype=jnp.float32)
    bmu = jax.random.randint(k2, (B,), 0, noc)
    kw = dict(xdim=xdim, hexa=True, gaussian=True)
    fwx, fws = dispatch.som_accumulate(xb, bmu, 0.05, 2.5, n_rows=noc, **kw)
    for offset in (0, 48, 96):
        wx, ws = dispatch.som_accumulate(xb, bmu, 0.05, 2.5, n_rows=32,
                                         unit_offset=jnp.int32(offset), **kw)
        np.testing.assert_allclose(np.asarray(wx),
                                   np.asarray(fwx[offset:offset + 32]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(ws),
                                   np.asarray(fws[offset:offset + 32]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_kernels_lower_for_cuda(k):
    """The winner kernel lowers through Pallas-Triton for CUDA at the
    north-star widths (B=4096, N=65,536, D=64) — this catches primitives
    or shapes the Triton route refuses, without a GPU (PTX is compiled on
    the card)."""
    from jax import export

    S = jax.ShapeDtypeStruct
    exp = export.export(
        jax.jit(functools.partial(winner_topk, k=k)), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(S((4096, 64), jnp.float32),
                                      S((65536, 64), jnp.float32))
    assert "xla.gpu.triton" in exp.mlir_module()


@pytest.mark.parametrize("backend,dim,masked,want", [
    ("cpu", 64, False, "xla"),
    ("gpu", 64, False, "triton"),
    ("gpu", 64, True, "xla"),
    ("gpu", 1000, False, "xla"),
])
def test_dispatch_selects_by_backend(backend, dim, masked, want):
    assert dispatch.winner_impl(dim, masked, backend) == want


def test_dist_argmin_top2_masked_match_oracle(monkeypatch):
    """Masked winner searches stay on XLA (the keep @ (M^2)^T form) and
    equal the masked oracle; the large-batch XLA path runs over row
    chunks with the same answers."""
    for B, N, D in ((64, 96, 5), (100, 520, 20)):
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(B), 3)
        x = jax.random.normal(k1, (B, D)) * 10
        m = jax.random.normal(k2, (N, D)) * 10
        mask = (jax.random.uniform(k3, (B, D)) < 0.3).astype(jnp.uint8)
        ridx, rval = find_winners(x, m, mask)
        idx, val = dispatch.find_bmu(x, m, mask)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(ridx))
        monkeypatch.setattr(dispatch, "_XLA_BLOCK_ELEMS", 16 * N)
        cidx, cval = dispatch.find_bmu(x, m, mask)
        monkeypatch.undo()
        np.testing.assert_array_equal(np.asarray(cidx), np.asarray(ridx))
        np.testing.assert_allclose(np.asarray(cval), np.asarray(rval),
                                   rtol=1e-6)
        tidx, _ = dispatch.find_top2(x, m, mask)
        ref2, _ = topk_winners(x, m, 2, mask)
        np.testing.assert_array_equal(np.asarray(tidx), np.asarray(ref2))


def test_chunked_topk_matches_exact(ref_dir):
    """Device-chunked kNN equals the host oracle incl. the reference
    (distance asc, index desc) tie order — on real data with ties."""
    from som_lvq_pak_tpu.data.io import read_data
    from som_lvq_pak_tpu.ops import exact
    from som_lvq_pak_tpu.ops.distance import chunked_topk

    data = read_data(os.path.join(ref_dir, "ex1.dat"))
    X = data.points[:700]
    ref_idx, ref_val = exact.pairwise_topk(X, X, 5)
    idx, val = chunked_topk(jnp.asarray(X), jnp.asarray(X), 5, chunk=256)
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    np.testing.assert_allclose(np.asarray(val), ref_val, rtol=1e-4, atol=1e-2)


def test_knn_correct_mask_fast_matches_parity(ref_dir):
    from som_lvq_pak_tpu.data.io import read_data
    from som_lvq_pak_tpu.models.lvq import knn_correct_mask

    data = read_data(os.path.join(ref_dir, "ex1.dat"))
    a = knn_correct_mask(data, 5, mode="parity")
    b = knn_correct_mask(data, 5, mode="fast")
    np.testing.assert_array_equal(a, b)


def test_lvq23_batch_step_improves():
    """Batch lvq2 on a separable mixture should not corrupt the codes and
    the window rule must leave out-of-window samples untouched."""
    from som_lvq_pak_tpu.models.fast import lvq23_batch_step

    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    # two classes at +-3 with 2 codes each
    codes = jnp.asarray([[-3.0, 0], [-2.5, 0], [2.5, 0], [3.0, 0]], dtype=jnp.float32)
    clabels = jnp.asarray([1, 1, 2, 2])
    xb = jnp.concatenate([
        jax.random.normal(k1, (64, 2)) * 0.5 - jnp.asarray([3.0, 0]),
        jax.random.normal(k2, (64, 2)) * 0.5 + jnp.asarray([3.0, 0]),
    ])
    xl = jnp.concatenate([jnp.full(64, 1), jnp.full(64, 2)])
    out = lvq23_batch_step(codes, clabels, xb, xl, 0.03, 0.3)
    assert np.isfinite(np.asarray(out)).all()
    # class means must stay on their own side
    assert np.asarray(out)[:2, 0].mean() < 0 < np.asarray(out)[2:, 0].mean()

    out3 = lvq23_batch_step(codes, clabels, xb, xl, 0.03, 0.3, 0.1, lvq3=True)
    assert np.isfinite(np.asarray(out3)).all()


def test_dist_topk_matches_oracle():
    """The chunked k-NN with lowest-index ties (reference_ties=False) ==
    topk_winners, across query chunks, incl. exact-tie order."""
    from som_lvq_pak_tpu.ops.distance import chunked_topk

    for B, N, D, k in ((32, 96, 5, 5), (64, 520, 20, 10), (16, 130, 7, 3)):
        k1, k2 = jax.random.split(jax.random.PRNGKey(B))
        x = jax.random.normal(k1, (B, D)) * 10
        m = jax.random.normal(k2, (N, D)) * 10
        i, v = chunked_topk(x, m, k, chunk=16, reference_ties=False)
        ri, rv = topk_winners(x, m, k)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))
        np.testing.assert_allclose(np.asarray(v), np.asarray(rv),
                                   rtol=1e-4, atol=1e-2)

    x = jnp.ones((8, 8))
    m = jnp.tile(jnp.arange(4.0)[:, None] % 2, (1, 8))
    m = jnp.concatenate([m, m], 0)
    i, _ = chunked_topk(x, m, 4, chunk=8, reference_ties=False)
    np.testing.assert_array_equal(np.asarray(i)[0], [1, 3, 5, 7])


def test_auto_pairwise_topk_routes_by_scale(ref_dir, monkeypatch):
    """Below the pair threshold the host exact path answers (goldens
    byte-identical by construction); above it the device-chunked path
    answers with the same indices."""
    from som_lvq_pak_tpu.data.io import read_data
    from som_lvq_pak_tpu.ops import exact
    from som_lvq_pak_tpu.ops.distance import auto_pairwise_topk

    data = read_data(os.path.join(ref_dir, "ex1.dat"))
    X = data.points[:600]
    ref_idx, _ = exact.pairwise_topk(X, X, 5)

    idx_small, _ = auto_pairwise_topk(X, X, 5)           # host path
    np.testing.assert_array_equal(idx_small, ref_idx)

    monkeypatch.setenv("SOMVQ_AUTO_TOPK_PAIRS", "1000")  # force device
    idx_dev, _ = auto_pairwise_topk(X, X, 5)
    np.testing.assert_array_equal(idx_dev, ref_idx)


def test_auto_pairwise_topk_masked_device_path(ref_dir, monkeypatch):
    """Masked queries route through the device path with the same
    indices as the exact host path (mask excludes components from the
    distance, lvq_pak.c:63-72)."""
    from som_lvq_pak_tpu.data.io import read_data
    from som_lvq_pak_tpu.ops import exact
    from som_lvq_pak_tpu.ops.distance import auto_pairwise_topk

    data = read_data(os.path.join(ref_dir, "ex1.dat"))
    X = data.points[:400]
    mask = np.zeros(X.shape, np.uint8)
    mask[::7, 3] = 1
    mask[::11, 0] = 1
    ref_idx, _ = exact.pairwise_topk(X, X, 5, mask)
    monkeypatch.setenv("SOMVQ_AUTO_TOPK_PAIRS", "1000")
    idx, _ = auto_pairwise_topk(X, X, 5, mask)
    np.testing.assert_array_equal(idx, ref_idx)
