"""Selection math and the data plane of the port against the JAX package.

``segment_pack`` and ``segmented_rage_select`` (requested indices, new
cluster ages and the segment layout) must equal the reference exactly on
the same handed-over gradients, with multi-member clusters and ties in
both magnitudes and ages. The device sampler cannot reproduce threefry
draws, so it is held to the properties ``tests/test_data.py`` pins.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import strategies as JS
from repro.fl import engine as JE

from repro_torch.core import strategies as TS
from repro_torch.data.pipeline import DeviceShardStore
from repro_torch.fl import engine as TE


@pytest.mark.parametrize("labels,num_segments,max_seg", [
    ([0, 1, 2, 3], 4, 1), ([1, 0, 1, 2, 0, 2, 2], 3, 3),
    ([1, 0, 1, 2, 0, 2, 2], 3, 2), ([3, 3, 0, 1, 0, 3], 2, 4),
    ([0, 0, 0, 0, 0], 5, 5)])
def test_segment_pack_matches(labels, num_segments, max_seg):
    cl = np.asarray(labels, np.int32)
    want = np.asarray(JS.segment_pack(jnp.asarray(cl), num_segments, max_seg))
    got = TS.segment_pack(torch.from_numpy(cl), num_segments, max_seg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


_PAIRS = [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]          # five label pairs
_MIXED = [2, 0, 1, 0, 2, 3, 1, 3, 4, 2]          # interleaved, size 3


@pytest.mark.parametrize("cluster_of,bounds,candidates,disjoint", [
    (_PAIRS, True, "threshold", True), (_PAIRS, True, "sort", False),
    (_MIXED, True, "threshold", True), (_MIXED, True, "sort", False),
    (list(range(10)), True, "threshold", True),    # singletons (round 1)
    ([1, 0, 1, 0, 2, 2, 3, 4, 4, 0], False, "sort", True)])  # N x N bounds
def test_segmented_rage_select_matches(cluster_of, bounds, candidates,
                                       disjoint):
    n, d, r, k = 10, 600, 40, 8
    rng = np.random.default_rng(sum(cluster_of) + disjoint)
    G = rng.standard_normal((n, d)).astype(np.float32)
    G = (np.round(G * 8) / 8).astype(np.float32)      # magnitude ties
    # members of a cluster share gradient structure (overlapping picks)
    cl = np.asarray(cluster_of, np.int32)
    G[:, : d // 3] = G[cl, : d // 3] * np.float32(1.5)
    cluster_age = rng.integers(0, 5, (n, d)).astype(np.int32)   # age ties
    kw = {}
    if bounds:
        kw = dict(num_segments=int(cl.max()) + 1,
                  max_seg=int(np.bincount(cl).max()))
    j_idx, j_age, j_seg = JS.segmented_rage_select(
        jnp.asarray(G), jnp.asarray(cluster_age), jnp.asarray(cl), r=r, k=k,
        disjoint=disjoint, candidates=candidates, **kw)
    t_idx, t_age, t_seg = TS.segmented_rage_select(
        torch.from_numpy(G), torch.from_numpy(cluster_age),
        torch.from_numpy(cl), r=r, k=k, disjoint=disjoint,
        candidates=candidates, **kw)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_age.numpy(), np.asarray(j_age))
    np.testing.assert_array_equal(t_seg.members.numpy(),
                                  np.asarray(j_seg.members))
    np.testing.assert_array_equal(t_seg.idx.numpy(), np.asarray(j_seg.idx))


def test_client_candidates_sort_matches():
    rng = np.random.default_rng(4)
    G = (np.round(rng.standard_normal((5, 300)) * 4) / 4).astype(np.float32)
    np.testing.assert_array_equal(
        TS.client_candidates(torch.from_numpy(G), 30, "sort").numpy(),
        np.asarray(JS.client_candidates(jnp.asarray(G), 30, "sort")))


def test_member_age_row_matches():
    row = np.arange(20, dtype=np.int32)
    idx = np.asarray([3, 0, 19, 20, 7], np.int32)     # 20 = sentinel d
    np.testing.assert_array_equal(
        TE.member_age_row(torch.from_numpy(row), torch.from_numpy(idx)).numpy(),
        np.asarray(JE.member_age_row(jnp.asarray(row), jnp.asarray(idx))))


# -- device sampler: the properties tests/test_data.py pins ---------------

def test_device_store_draw_shapes_and_no_padding():
    rng = np.random.default_rng(0)
    # labels 1..5 only: a sampled padding row would show up as label 0
    shards = [(rng.normal(size=(n, 3, 2)).astype(np.float32),
               rng.integers(1, 6, n)) for n in (12, 17, 9)]
    store = DeviceShardStore(shards, 4, seed=0, device="cpu")
    assert store.bs == 4 and store.capacity == 17
    state = store.init_state()
    for _ in range(4):
        bx, by, state = store.draw(store.data, state, 3)
        assert bx.shape == (3, 3, 4, 3, 2) and by.shape == (3, 3, 4)
        for i, (xi, yi) in enumerate(shards):
            drawn = set(by[i].reshape(-1).tolist())
            assert 0 not in drawn and drawn <= set(yi.tolist())
            rows = bx[i].reshape(-1, 3, 2).numpy()
            assert all((xi == r).all(axis=(1, 2)).any() for r in rows)


@pytest.mark.parametrize("length,batch_size,seed", [
    (10, 4, 7), (12, 4, 1), (1, 3, 2), (37, 41, 3), (23, 5, 4), (16, 16, 5)])
def test_device_sampler_epoch_exact(length, batch_size, seed):
    """Without replacement within an epoch, `length // bs` full batches
    per epoch, the non-dividing tail dropped, exact cover when bs divides
    length, every batch full-size; one draw of H batches equals H draws
    of one."""
    x = np.arange(length, dtype=np.float32)[:, None]
    y = np.arange(length)
    store = DeviceShardStore([(x, y)], batch_size, seed=seed, device="cpu")
    bs = store.bs
    assert bs == min(batch_size, length)
    per_epoch = length // bs
    n_draws = 2 * per_epoch + 1
    state = store.init_state()
    draws = []
    for _ in range(n_draws):
        _, by, state = store.draw(store.data, state, 1)
        draws.append(by[0, 0].tolist())
    assert all(len(b) == bs for b in draws)
    for e in range(0, n_draws, per_epoch):
        epoch = draws[e:e + per_epoch]
        flat = [s for b in epoch for s in b]
        assert len(set(flat)) == len(flat)
        assert set(flat) <= set(range(length))
        if len(epoch) == per_epoch and length % bs == 0:
            assert sorted(flat) == list(range(length))
    store2 = DeviceShardStore([(x, y)], batch_size, seed=seed, device="cpu")
    _, by, _ = store2.draw(store2.data, store2.init_state(), n_draws)
    assert by[0].tolist() == draws
