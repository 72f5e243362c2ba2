"""The port's four kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; those
are held against the Pallas kernels run in interpret mode, on inputs made
from a seed with numpy: ragged d, NaN, +/-inf, zeros and denormals,
magnitude ties, age ties, taken lanes, invalid member slots, and the
sentinel indices d and -2. Integers compare exactly; the float sums of
``sparse_aggregate`` within rtol=1e-5, atol=1e-6 (the Pallas kernel sums
by a one-hot matmul, whose order differs from upload order once three or
more uploads share an index).

The tests marked ``cuda`` hold each CUDA kernel against its plain version
on the card and skip where there is none; ``sparse_aggregate``'s dense
sum there must also equal ``numpy.add.at`` in float32, bitwise, since
the kernel adds each coordinate's uploads in upload order. They need no
JAX, so the file also runs on a machine with a card and no JAX (the
comparisons with the JAX package then skip).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels import maghist as JMH
    from repro.kernels import ops as jops
except ImportError:
    jax = None

from repro_torch.kernels import build
from repro_torch.kernels import maghist as MH
from repro_torch.kernels import ops
from repro_torch.kernels import segmented_topk as ST
from repro_torch.kernels import sparse_aggregate as SA

_SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -3e-39,
                     2.0 ** -45, 2.0 ** -40, 2.0 ** -39, 3e38, 1.0, -1.0,
                     2.0 ** 23, 2.0 ** 24], np.float32)


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs JAX, the reference")


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
def test_hist_rows_matches_pallas_maghist(jax_ref, n, d):
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


@pytest.mark.parametrize("d", [4096, 9000, 13])
def test_hist_blocks_matches_pallas_maghist(jax_ref, d):
    """Per-block histograms of each row against the single-vector Pallas
    kernel on the zero-padded row, as the reference's wrapper pads."""
    G = _grads(3, d, seed=d)
    pad = (-d) % JMH.BLOCK_D
    got = ops.maghist(torch.from_numpy(G))
    assert got.dtype == torch.int32
    assert got.shape == (3, (d + pad) // JMH.BLOCK_D, JMH.NBINS)
    for i in range(3):
        want = np.asarray(JMH.maghist(jnp.asarray(np.pad(G[i], (0, pad))),
                                      interpret=True))
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(
            ops.maghist(torch.from_numpy(G[i])).numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(jops.maghist(jnp.asarray(G[i]))), want)


@pytest.mark.parametrize("d,r", [(9000, 75), (777, 10), (300, 200),
                                 (13, 13)])
def test_threshold_topk_matches_reference(jax_ref, d, r):
    """One vector and row-wise, vals (masked magnitudes) and indices
    exactly, on rows with NaN, inf, zeros, denormals and magnitude ties."""
    G = _grads(3, d, seed=d + r, ties=True)
    G[1, : d // 2] = 0.0
    for i in range(3):
        j_vals, j_idx = jops.threshold_topk(jnp.asarray(G[i]), r)
        t_vals, t_idx = ops.threshold_topk(torch.from_numpy(G[i]), r)
        assert t_idx.dtype == torch.int32 and t_idx.shape == (r,)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(t_vals.numpy(), np.asarray(j_vals))
    t_vals, t_idx = ops.threshold_topk(torch.from_numpy(G), r)
    j_vals, j_idx = jax.vmap(lambda g: jops.threshold_topk(g, r))(
        jnp.asarray(G))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(j_vals))


def test_threshold_topk_nan_laws(jax_ref):
    """The result is the stable top-r of where(isnan, -1, |g|) for any
    input: NaN is never a candidate, the finite and inf top-r always is."""
    rng = np.random.default_rng(9)
    g = rng.normal(size=(300,)).astype(np.float32)
    g[::7] = np.nan
    g[3], g[50] = np.inf, -np.inf
    g[100:140] = 0.0
    g[200:220] = 1e-42
    G = np.stack([g, np.zeros_like(g), np.full_like(g, np.nan),
                  rng.normal(size=(300,)).astype(np.float32)])
    for r in (5, 64, 300):
        want = jax.lax.top_k(jnp.where(jnp.isnan(G), -1.0, jnp.abs(G)), r)
        vals, idx = ops.threshold_topk(torch.from_numpy(G), r)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(ops.threshold_topk(
            torch.from_numpy(g), r)[1].numpy(), np.asarray(want[1][0]))
        # non-candidates read -1; survivors keep their magnitudes
        np.testing.assert_array_equal(
            vals.numpy(), np.where(vals.numpy() < 0, -1.0,
                                   np.asarray(want[0])))
    all_nan = ops.threshold_topk(torch.from_numpy(G[2]), 5)[0]
    assert all_nan.tolist() == [-1] * 5


@pytest.mark.parametrize("n,d,r,special,ties", [
    (4, 1000, 75, False, False), (4, 1000, 75, False, True),
    (3, 777, 10, True, False), (2, 300, 200, False, True),
    (2, 100, 90, True, False)])
def test_threshold_topk_batch_matches_reference(jax_ref, n, d, r, special,
                                               ties):
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
def test_segmented_age_topk_plain_matches_pallas(jax_ref, C, S, r, k,
                                                 disjoint):
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
def test_sparse_aggregate_plain_matches_pallas(jax_ref, d, nk):
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
        MH.maghist(x)
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
@pytest.mark.parametrize("shape", [(39_760,), (10, 39_760), (1, 4097),
                                   (3, 13)])
def test_maghist_kernel_matches_plain(cuda, shape):
    G = torch.from_numpy(_grads(1, int(np.prod(shape)), seed=shape[-1])
                         ).reshape(shape).to(cuda)
    before = build.LAUNCHES["maghist"]
    got = MH.maghist(G)
    assert build.LAUNCHES["maghist"] == before + 1
    torch.testing.assert_close(got, MH.hist_blocks(G), rtol=0, atol=0)
    for a, b in zip(ops.threshold_topk(G, min(75, shape[-1])),
                    ops.threshold_topk(G.cpu(), min(75, shape[-1]))):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


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
    np.testing.assert_array_equal(dense.cpu().numpy(),
                                  _upload_order_sum(idx, vals, d))
    again, _ = SA.sparse_aggregate(*args)
    assert torch.equal(dense, again)            # no order-varying atomics


def _upload_order_sum(idx, vals, d):
    ok = (idx >= 0) & (idx < d)
    out = np.zeros(d, np.float32)
    np.add.at(out, idx[ok], vals[ok])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("nk,span", [(1000, None), (250_000, 1000),
                                     (250_000, None)])
def test_sparse_aggregate_kernel_is_the_upload_order_sum(cuda, nk, span):
    """At the CIFAR CNN's d = 2,515,338: the paper's 10 x 100 uploads,
    250,000 uploads into 1,000 coordinates (about 250 a coordinate), and
    250,000 spread over d. Dense sums bitwise equal to numpy.add.at in
    float32, ages exactly the plain version's."""
    d = 2_515_338
    rng = np.random.default_rng(nk + (span or 0))
    idx = rng.integers(-3, (span or d) + 3, nk).astype(np.int32)
    idx[-2:] = d, -2
    vals = rng.standard_normal(nk).astype(np.float32)
    age = rng.integers(0, 30, d).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (idx, vals, age)]
    before = build.LAUNCHES["sparse_aggregate"]
    dense, new_age = SA.sparse_aggregate(*args)
    assert build.LAUNCHES["sparse_aggregate"] == before + 1
    np.testing.assert_array_equal(dense.cpu().numpy(),
                                  _upload_order_sum(idx, vals, d))
    torch.testing.assert_close(new_age, SA.sparse_aggregate_plain(*args)[1],
                               rtol=0, atol=0)
    assert torch.equal(dense, SA.sparse_aggregate(*args)[0])


@pytest.mark.parametrize("masked", [False, True])
def test_server_aggregation_matches(jax_ref, masked):
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
