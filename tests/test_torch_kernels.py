"""The port's three kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; those
are held against the Pallas kernels run in interpret mode, on inputs made
from a seed with numpy: ragged d, NaN, +/-inf, zeros and denormals,
magnitude ties, age ties, taken lanes, invalid member slots, and the
sentinel indices d and -2. Integers compare exactly; the float sums of
``sparse_aggregate`` within rtol=1e-5, atol=1e-6 (the Pallas kernel sums
by a one-hot matmul, whose order differs from upload order once three or
more uploads share an index).

The tests marked ``cuda`` hold each CUDA kernel against its plain version
on the card and skip where there is none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import maghist as JMH
from repro.kernels import ops as jops

from repro_torch.kernels import build
from repro_torch.kernels import maghist as MH
from repro_torch.kernels import ops
from repro_torch.kernels import segmented_topk as ST
from repro_torch.kernels import sparse_aggregate as SA

_SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -3e-39,
                     2.0 ** -45, 2.0 ** -40, 2.0 ** -39, 3e38, 1.0, -1.0,
                     2.0 ** 23, 2.0 ** 24], np.float32)


def _grads(n, d, seed, *, special=True, ties=False):
    rng = np.random.default_rng(seed)
    G = (rng.standard_normal((n, d))
         * 10.0 ** rng.integers(-12, 4, (n, d))).astype(np.float32)
    if ties:                            # few distinct magnitudes
        G = (np.round(G * 4) / 4).astype(np.float32)
    if special:
        for i in range(n):
            pos = rng.choice(d, min(d, len(_SPECIAL)), replace=False)
            G[i, pos] = _SPECIAL[:len(pos)]
    return G


@pytest.mark.parametrize("n,d", [(1, 512), (3, 1000), (10, 39_760 // 8)])
def test_hist_rows_matches_pallas_maghist(n, d):
    G = _grads(n, d, seed=n * d)
    pad = (-d) % 512
    hist_j = np.array(JMH.maghist_batch(
        jnp.asarray(np.pad(G, ((0, 0), (0, pad)))), interpret=True,
        block_d=512))
    hist_j[:, 0] -= pad                 # the zero padding lands in bin 0
    hist_t = ops.maghist_batch(torch.from_numpy(G))
    assert hist_t.dtype == torch.int32
    np.testing.assert_array_equal(hist_t.numpy(), hist_j)
    np.testing.assert_array_equal(
        MH.exponent_bins(torch.from_numpy(np.abs(_SPECIAL))).numpy(),
        np.asarray(JMH.exponent_bins(jnp.asarray(np.abs(_SPECIAL)))))


@pytest.mark.parametrize("n,d,r,special,ties", [
    (4, 1000, 75, False, False), (4, 1000, 75, False, True),
    (3, 777, 10, True, False), (2, 300, 200, False, True),
    (2, 100, 90, True, False)])
def test_threshold_topk_batch_matches_reference(n, d, r, special, ties):
    G = _grads(n, d, seed=d + r, special=special, ties=ties)
    G[0, :d // 2] = 0.0                 # a half-zero row
    Gt = torch.from_numpy(G)
    tau_t = MH.threshold_from_hist_batch(MH.hist_rows(Gt), r)
    tau_j = JMH.threshold_from_hist_batch(JMH.hist_rows(jnp.asarray(G)), r)
    np.testing.assert_array_equal(tau_t.numpy().view(np.int32),
                                  np.asarray(tau_j).view(np.int32))
    got = ops.threshold_topk_batch(Gt, r)
    assert got.dtype == torch.int32 and got.shape == (n, r)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.threshold_topk_batch(jnp.asarray(G), r)))


def _segment_inputs(C, S, r, seed):
    """Members of a cluster share part of their candidates (so taken lanes
    occur), ages take few values (ties), some member slots are invalid."""
    rng = np.random.default_rng(seed)
    cand = np.stack([np.stack([rng.choice(3 * r, r, replace=False)
                               for _ in range(S)]) for _ in range(C)])
    cand[:, 1:, : r // 2] = cand[:, :1, : r // 2]
    age = rng.integers(0, 4, (C, S, r))
    valid = rng.random((C, S)) < 0.75
    valid[:, 0] = True
    return cand.astype(np.int32), age.astype(np.int32), valid


@pytest.mark.parametrize("C,S,r,k", [(10, 2, 75, 10), (3, 4, 20, 5),
                                     (2, 3, 7, 7), (1, 1, 130, 3)])
@pytest.mark.parametrize("disjoint", [True, False])
def test_segmented_age_topk_plain_matches_pallas(C, S, r, k, disjoint):
    cand, age, valid = _segment_inputs(C, S, r, seed=C * S * r + k)
    out_j = np.asarray(jops.segmented_age_topk(
        jnp.asarray(cand), jnp.asarray(age), jnp.asarray(valid), k,
        disjoint=disjoint))
    out_t = ops.segmented_age_topk(torch.from_numpy(cand),
                                   torch.from_numpy(age),
                                   torch.from_numpy(valid), k,
                                   disjoint=disjoint)
    assert out_t.dtype == torch.int32 and out_t.shape == (C, S, k)
    m = np.broadcast_to(valid[:, :, None], (C, S, k))
    np.testing.assert_array_equal(out_t.numpy()[m], out_j[m])


def test_segmented_age_topk_semantics_and_k_check():
    cand = torch.tensor([[[0, 1, 2, 3], [0, 1, 2, 3]]], dtype=torch.int32)
    age = torch.tensor([[[9, 8, 7, 6], [9, 8, 7, 6]]], dtype=torch.int32)
    valid = torch.ones((1, 2), dtype=torch.bool)
    out = ops.segmented_age_topk(cand, age, valid, 2)
    assert out.tolist() == [[[0, 1], [2, 3]]]
    out = ops.segmented_age_topk(cand, age, valid, 2, disjoint=False)
    assert out.tolist() == [[[0, 1], [0, 1]]]
    with pytest.raises(ValueError):
        ops.segmented_age_topk(cand, age, valid, 5)


@pytest.mark.parametrize("d,nk", [(1000, 100), (39_760 // 8, 300),
                                  (513, 2000)])
def test_sparse_aggregate_plain_matches_pallas(d, nk):
    rng = np.random.default_rng(d + nk)
    idx = rng.integers(0, d, nk).astype(np.int32)
    idx[: nk // 4] = idx[nk // 4: nk // 2]          # duplicates
    idx[rng.choice(nk, nk // 10, replace=False)] = d  # sentinel d
    idx[rng.choice(nk, nk // 10, replace=False)] = -2
    vals = rng.standard_normal(nk).astype(np.float32)
    age = rng.integers(0, 30, d).astype(np.int32)
    dense_j, age_j = jops.sparse_aggregate(jnp.asarray(idx),
                                           jnp.asarray(vals),
                                           jnp.asarray(age))
    dense_t, age_t = ops.sparse_aggregate(torch.from_numpy(idx),
                                          torch.from_numpy(vals),
                                          torch.from_numpy(age))
    assert dense_t.dtype == torch.float32 and age_t.dtype == torch.int32
    np.testing.assert_allclose(dense_t.numpy(), np.asarray(dense_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(age_t.numpy(), np.asarray(age_j))


def test_cuda_launchers_refuse_cpu_tensors():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        MH.maghist_batch(x)
    with pytest.raises(ValueError, match="CUDA"):
        SA.sparse_aggregate(torch.zeros(4, dtype=torch.int32),
                            torch.zeros(4), torch.zeros(8, dtype=torch.int32))


# -- on the card: each CUDA kernel against its plain version ---------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(10, 39_760), (3, 1000), (1, 4097)])
def test_maghist_batch_kernel_matches_plain(cuda, n, d):
    G = torch.from_numpy(_grads(n, d, seed=d)).to(cuda)
    before = build.LAUNCHES["maghist_batch"]
    got = MH.maghist_batch(G)
    assert build.LAUNCHES["maghist_batch"] == before + 1
    torch.testing.assert_close(got, MH.hist_rows(G), rtol=0, atol=0)
    np.testing.assert_array_equal(
        ops.threshold_topk_batch(G, 75).cpu().numpy(),
        ops.threshold_topk_batch(G.cpu(), 75).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("C,S,r,k", [(10, 2, 75, 10), (3, 4, 300, 5),
                                     (2, 3, 7, 7)])
@pytest.mark.parametrize("disjoint", [True, False])
def test_segmented_age_topk_kernel_matches_plain(cuda, C, S, r, k, disjoint):
    cand, age, valid = (torch.from_numpy(a).to(cuda)
                        for a in _segment_inputs(C, S, r, seed=r))
    got = ST.segmented_age_topk(cand, age, valid, k, disjoint=disjoint)
    want = ST.segmented_age_topk_plain(cand, age, valid, k,
                                       disjoint=disjoint)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d,nk", [(39_760, 100), (1000, 3000)])
def test_sparse_aggregate_kernel_matches_plain(cuda, d, nk):
    rng = np.random.default_rng(nk)
    idx = rng.integers(-3, d + 3, nk).astype(np.int32)
    idx[: nk // 4] = idx[nk // 4: nk // 2]
    vals = rng.standard_normal(nk).astype(np.float32)
    age = rng.integers(0, 30, d).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (idx, vals, age)]
    dense, new_age = SA.sparse_aggregate(*args)
    dense_p, age_p = SA.sparse_aggregate_plain(*args)
    torch.testing.assert_close(dense, dense_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(new_age, age_p, rtol=0, atol=0)
    again, _ = SA.sparse_aggregate(*args)
    assert torch.equal(dense, again)            # no order-varying atomics


@pytest.mark.parametrize("masked", [False, True])
def test_server_aggregation_matches(masked):
    """fl.server: the client-layout sum and the fused sum + hit ages, with
    a per-row mask and sentinel rows, against the reference's XLA path."""
    from repro.fl import server as JSrv
    from repro_torch.fl import server as TSrv
    rng = np.random.default_rng(7)
    n, k, d = 6, 5, 400
    idx = rng.integers(0, d, (n, k)).astype(np.int32)
    idx[2] = d                                       # a sentinel row
    vals = rng.standard_normal((n, k)).astype(np.float32)
    age = rng.integers(0, 9, d).astype(np.int32)
    mask = rng.random(n) < 0.6 if masked else None
    np.testing.assert_allclose(
        TSrv.aggregate_sparse(torch.from_numpy(idx), torch.from_numpy(vals),
                              d).numpy(),
        np.asarray(JSrv.aggregate_sparse(jnp.asarray(idx),
                                         jnp.asarray(vals), d)),
        rtol=1e-5, atol=1e-6)
    dj, aj = JSrv.aggregate_sparse_fused(
        jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(age), impl="jnp",
        mask=None if mask is None else jnp.asarray(mask))
    dt, at = TSrv.aggregate_sparse_fused(
        torch.from_numpy(idx), torch.from_numpy(vals), torch.from_numpy(age),
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
