"""The port's rAge-k candidate report and the steps of its kernels.

On the CPU ``ops.threshold_topk_batch`` runs its plain version; it is held
against the JAX package's ``threshold_topk_batch`` (both of its histogram
paths, the Pallas one in interpret mode) on rows made from a seed with
numpy: many equal magnitudes, one value, one binade, NaN, +/-inf, +/-0,
denormals, huge values, d not a multiple of the kernels' chunk, r = d and
fewer than r non-NaN values. ``report.threshold_topk_batch_steps`` repeats
the CUDA kernels' steps (block counts, compaction by block offsets, the
radix refine, the sort) and is pinned equal to the plain version with sort
buffers small enough that every branch runs, the runs-and-merges sort of
r past the shared buffer included; with its magnitudes it is the
baselines' report, pinned to the JAX ``ops.threshold_topk``.
``segmented_age_topk``'s
rank-then-walk steps (``segmented_age_topk_ranked``) are pinned to its
plain version and, at clusters too large for one block's shared memory,
to the JAX oracle; the "fewer than k untaken lanes" cases to the Pallas
kernel. Everything compares exactly.

The tests marked ``cuda`` hold the kernels on the card against the plain
versions on the CPU, and skip where there is no card.
"""
import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

try:
    import jax
    import jax.numpy as jnp
    from repro.core import strategies as JS
    from repro.kernels import ops as jops
except ImportError:
    jax = None

from repro_torch.kernels import build
from repro_torch.kernels import maghist as MH
from repro_torch.kernels import ops
from repro_torch.kernels import report as RP
from repro_torch.kernels import segmented_topk as ST

_SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -3e-39,
                     2.0 ** -45, 2.0 ** -40, 2.0 ** -39, 3e38, 1.0, -1.0,
                     2.0 ** 23, 2.0 ** 24], np.float32)


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs JAX, the reference")


def _row(kind, d, rng):
    """One row of a kind that drives one branch of the report."""
    if kind == "normal":
        return (rng.standard_normal(d) * 10.0 ** rng.integers(-12, 4, d))
    if kind == "ties":            # few distinct magnitudes, many equal
        return np.round(rng.standard_normal(d) * 4) / 4
    if kind == "one_value":
        return np.full(d, -0.3)
    if kind == "one_binade":      # every value in [1, 2): the refine case
        return rng.choice([-1.0, 1.0], d) * (1.0 + rng.random(d))
    if kind == "specials":
        g = rng.standard_normal(d)
        pos = rng.choice(d, min(d, 3 * len(_SPECIAL)), replace=False)
        g[pos] = np.resize(_SPECIAL, len(pos))
        return g
    if kind == "denormals":       # bin 0 holds everything: tau = 0
        return rng.integers(-50, 50, d).astype(np.float32) * np.float32(
            2.0 ** -140)
    if kind == "huge":            # the top bin: many exponents and inf
        g = rng.standard_normal(d) * 2.0 ** rng.integers(23, 120, d)
        g[rng.choice(d, 3, replace=False)] = np.inf
        return g
    if kind == "half_zero":
        g = rng.standard_normal(d)
        g[: d // 2] = 0.0
        return g
    if kind == "mostly_nan":      # fewer than r non-NaN values
        g = np.full(d, np.nan)
        g[rng.choice(d, 5, replace=False)] = rng.standard_normal(5)
        return g
    if kind == "all_nan":
        return np.full(d, np.nan)
    raise ValueError(kind)


KINDS = ["normal", "ties", "one_value", "one_binade", "specials",
         "denormals", "huge", "half_zero", "mostly_nan", "all_nan"]


def _rows(kinds, d, seed):
    rng = np.random.default_rng(seed)
    return np.stack([_row(k, d, rng) for k in kinds]).astype(np.float32)


def _stable_top_r(G, r):
    """The contract: the stable top-r of where(isnan, -1, |g|)."""
    m = np.where(np.isnan(G), -1.0, np.abs(G))
    return np.argsort(-m, axis=1, kind="stable")[:, :r].astype(np.int32)


@pytest.mark.parametrize("d,r", [(1000, 75), (4099, 75), (300, 300),
                                 (13, 13), (2000, 512)])
def test_report_matches_jax(jax_ref, d, r):
    """ops.threshold_topk_batch (the plain version on the CPU) against the
    JAX package's, on both of its histogram paths, on every kind of row;
    NaN rows against the contract, which the JAX package's own tests pin."""
    G = _rows(KINDS, d, seed=d + r)
    got = ops.threshold_topk_batch(torch.from_numpy(G), r)
    assert got.dtype == torch.int32 and got.shape == (len(KINDS), r)
    np.testing.assert_array_equal(got.numpy(), _stable_top_r(G, r))
    for impl in ("jnp", "pallas"):
        want = np.asarray(jops.threshold_topk_batch(jnp.asarray(G), r,
                                                    hist_impl=impl))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,r", [(1000, 75), (9000, 75), (300, 300),
                                 (13, 13), (2000, 200)])
@pytest.mark.parametrize("cap", ["default", "tight"])
@pytest.mark.parametrize("chunk", [64, None])
def test_report_steps_match_plain(d, r, cap, chunk):
    """The kernels' steps equal the plain version on every kind of row,
    with the kernel's sort buffer and with the least one (the power of two
    at or above r), which forces the refine and, on the rows of one value,
    the first holders of the last key."""
    G = torch.from_numpy(_rows(KINDS, d, seed=7 * d + r))
    sort_cap = None if cap == "default" else 1 << (r - 1).bit_length()
    got = RP.threshold_topk_batch_steps(G, r, chunk=chunk, sort_cap=sort_cap)
    np.testing.assert_array_equal(got.numpy(),
                                  RP.threshold_topk_batch_plain(G, r).numpy())


@pytest.mark.parametrize("d,r,cap,chunk", [(1000, 300, 64, None),
                                          (2000, 700, 256, 64),
                                          (300, 300, 8, None),
                                          (13, 13, 4, None),
                                          (5000, 1200, 128, 512)])
def test_report_steps_run_and_merge_match_plain(d, r, cap, chunk):
    """A shared sort of ``cap`` < r pairs: the steps refine to the power of
    two at or above 1.5 r, sort runs of ``cap`` pairs and merge them
    pairwise, as the kernel does past MAX_R; equal to the plain version on
    every kind of row."""
    G = torch.from_numpy(_rows(KINDS, d, seed=3 * d + r))
    got = RP.threshold_topk_batch_steps(G, r, chunk=chunk, sort_cap=cap)
    np.testing.assert_array_equal(got.numpy(),
                                  RP.threshold_topk_batch_plain(G, r).numpy())


def _nan_law_rows():
    """The rows of ``test_threshold_topk_nan_laws`` (NaN, +/-inf, zeros,
    denormals, an all-zero and an all-NaN row), then ties, denormals alone,
    huge values and mostly NaN."""
    rng = np.random.default_rng(9)
    g = rng.normal(size=(300,)).astype(np.float32)
    g[::7] = np.nan
    g[3], g[50] = np.inf, -np.inf
    g[100:140] = 0.0
    g[200:220] = 1e-42
    return np.concatenate([
        np.stack([g, np.zeros_like(g), np.full_like(g, np.nan),
                  rng.normal(size=(300,)).astype(np.float32)]),
        _rows(["ties", "denormals", "huge", "mostly_nan"], 300, seed=9)])


@pytest.mark.parametrize("r,cap", [(5, None), (5, 4), (64, 16), (64, None),
                                   (300, 64), (300, None)])
def test_baselines_report_steps_match_jax(jax_ref, r, cap):
    """The baselines' report (``ops.threshold_topk``) is the candidate
    report with its magnitudes: the kernels' steps with vals, through the
    shared sort and through runs and merges (cap < r), equal the JAX
    ``ops.threshold_topk`` row by row, vals and indices exactly."""
    G = _nan_law_rows()
    want_vals, want_idx = jax.vmap(lambda g: jops.threshold_topk(g, r))(
        jnp.asarray(G))
    vals, idx = RP.threshold_topk_batch_steps(torch.from_numpy(G), r,
                                              sort_cap=cap, vals=True)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def test_fine_slots_refine_the_exponent_bins():
    """The report's counts are by fine bin: ordered as the magnitudes are
    (NaN aside), and the four of bin b sum to bin b of hist_rows."""
    G = torch.from_numpy(_rows(KINDS, 3000, seed=11))
    slots = MH.fine_slots(G)
    for g, s in zip(G, slots):
        ok = ~torch.isnan(g)
        order = torch.argsort(g[ok].abs())
        assert bool((s[ok][order].diff() >= 0).all())
        assert bool((s[~ok] == MH.SLOTS - 1).all())
    fine = torch.stack([torch.bincount(s, minlength=MH.SLOTS) for s in slots])
    rows = fine[:, :-1].view(len(G), MH.NBINS, -1).sum(-1)
    rows[:, 0] += fine[:, -1]
    np.testing.assert_array_equal(rows.int().numpy(), MH.hist_rows(G).numpy())


def test_report_cut_and_sort_buffer():
    for d in (1, 13, 4096, 4097, 39_760, 262_144, 262_145, 2_515_338,
              100_000_000):
        chunk = MH.chunk_for(d)
        parts = -(-d // chunk)
        assert chunk % MH.BLOCK_D == 0 and 1 <= parts <= MH.MAX_PARTS
        assert chunk == MH.BLOCK_D or -(-d // (chunk - MH.BLOCK_D)) > 64
    assert MH.chunk_for(39_760) == 4096 and MH.chunk_for(2_515_338) == 40_960
    for r in (1, 75, 256, 257, 2500, 4096, 8192):
        cap = RP.sort_cap_for(r)
        assert cap & (cap - 1) == 0 and r <= cap <= RP.MAX_R
        assert cap >= min(RP.MAX_R, r + r // 2)
    # past MAX_R the buffer, in device memory, keeps 1.5 r
    assert [RP.sort_cap_for(r) for r in (8193, 10_000, 20_000)] == [
        16_384, 16_384, 32_768]
    with pytest.raises(ValueError, match="CUDA"):
        RP.threshold_topk_batch(torch.zeros((2, 8)), 3)


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


def _fallback_inputs(C, S, r, seed):
    """Every member holds the same candidates at equal ages, every slot
    valid: with r = k, each member after the first finds fewer than k
    untaken lanes and takes the taken ones in lane order."""
    rng = np.random.default_rng(seed)
    cand = np.broadcast_to(np.stack([rng.choice(4 * r, r, replace=False)
                                     for _ in range(C)])[:, None],
                           (C, S, r)).copy()
    cand[:, 1:, 0] = 4 * r + np.arange(S - 1)   # one lane never taken
    return (cand.astype(np.int32), np.full((C, S, r), 2, np.int32),
            np.ones((C, S), bool))


@pytest.mark.parametrize("C,S,r,k", [(10, 1, 75, 10), (5, 2, 75, 10),
                                     (3, 4, 20, 5), (2, 3, 7, 7),
                                     (1, 1, 130, 3)])
@pytest.mark.parametrize("disjoint", [True, False])
def test_segmented_ranked_steps_match_plain(C, S, r, k, disjoint):
    cand, age, valid = (torch.from_numpy(a) for a in
                        _segment_inputs(C, S, r, seed=C * S + r + k))
    np.testing.assert_array_equal(
        ST.segmented_age_topk_ranked(cand, age, valid, k,
                                     disjoint=disjoint).numpy(),
        ST.segmented_age_topk_plain(cand, age, valid, k,
                                    disjoint=disjoint).numpy())


@pytest.mark.parametrize("C,S,r", [(2, 3, 7), (3, 3, 10)])
def test_segmented_fallback_matches_pallas(jax_ref, C, S, r):
    """r = k, disjoint, S = 3, all ages equal: the taken lanes fill each
    later member's picks in lane order, as the Pallas kernel picks them."""
    cand, age, valid = _fallback_inputs(C, S, r, seed=r)
    want = np.asarray(jops.segmented_age_topk(
        jnp.asarray(cand), jnp.asarray(age), jnp.asarray(valid), r))
    args = [torch.from_numpy(a) for a in (cand, age, valid)]
    np.testing.assert_array_equal(
        ops.segmented_age_topk(*args, r).numpy(), want)
    np.testing.assert_array_equal(
        ST.segmented_age_topk_ranked(*args, r).numpy(), want)


def test_segmented_layout():
    """One block a cluster while its shared memory fits, the device-memory
    path past it (from S = 156 at fig3's r and k, S = 6 at CIFAR's, and a
    member past 8,192 lanes), with the hash in device memory once its
    slots overflow shared memory; no cap on S."""
    for S, r, k in ((1, 75, 10), (2, 75, 10), (1, 2500, 100), (2, 2500, 100),
                    (3, 7, 7), (4, 300, 5), (155, 75, 10), (5, 2500, 100),
                    (156, 75, 10), (256, 75, 10), (6, 2500, 100),
                    (2, 10_000, 50), (170, 120, 100)):
        lay = ST.layout(S, r, k)
        assert lay["rp"] >= r and lay["rp"] & (lay["rp"] - 1) == 0
        assert lay["hash"] >= 2 * S * k and lay["hash"] & (lay["hash"] - 1) == 0
        assert 32 <= lay["threads"] <= 1024
        assert lay["smem"] <= ST.SMEM_LIMIT
        big = 8 * (S * lay["rp"] * 17 // 16) + 4 * (S * r + lay["hash"])
        assert lay["path"] == ("global" if big > ST.SMEM_LIMIT else "block")
        assert lay["hash_smem"] == (lay["path"] == "block" or 4 * lay["hash"]
                                    <= ST.SMEM_LIMIT - ST.STATIC_SMEM)
    assert ST.layout(155, 75, 10)["path"] == "block"
    assert ST.layout(156, 75, 10)["path"] == "global"
    assert ST.layout(6, 2500, 100)["path"] == "global"
    assert not ST.layout(170, 120, 100)["hash_smem"]
    cand = torch.zeros((1, 8, 20_000), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ST.segmented_age_topk(cand, cand, torch.ones((1, 8)), 10)


@pytest.mark.parametrize("S", [156, 256])
@pytest.mark.parametrize("disjoint", [True, False])
def test_segmented_ranked_matches_jax_oracle_at_large_S(jax_ref, S,
                                                         disjoint):
    """A cluster of S members at fig3's r 75, k 10, past one block's shared
    memory: the rank-then-walk steps and the plain version equal the JAX
    oracle (``repro.core.strategies.segmented_age_topk``)."""
    cand, age, valid = _segment_inputs(1, S, 75, seed=S)
    want = np.asarray(JS.segmented_age_topk(
        jnp.asarray(cand), jnp.asarray(age), jnp.asarray(valid), 10,
        disjoint=disjoint))
    args = [torch.from_numpy(a) for a in (cand, age, valid)]
    np.testing.assert_array_equal(
        ST.segmented_age_topk_ranked(*args, 10, disjoint=disjoint).numpy(),
        want)
    np.testing.assert_array_equal(
        ST.segmented_age_topk_plain(*args, 10, disjoint=disjoint).numpy(),
        want)


# -- on the card: the kernels against the plain versions on the CPU --------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,r", [(39_760, 75), (4099, 75), (300, 300),
                                 (13, 13), (9000, 2500), (20_000, 8192)])
def test_report_kernel_matches_plain(cuda, d, r):
    G = torch.from_numpy(_rows(KINDS, d, seed=d + r))
    before = dict(build.LAUNCHES)
    got = RP.threshold_topk_batch(G.to(cuda), r)
    rose = {k: build.LAUNCHES[k] - before[k] for k in before}
    assert rose == {**{k: 0 for k in before}, "maghist_batch": 1,
                    "threshold_topk_batch": 1}
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  RP.threshold_topk_batch_plain(G, r).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,r", [(2, 200_000, 20_000),
                                   (1, 2_515_338, 10_000)])
def test_report_kernel_past_the_shared_sort(cuda, n, d, r):
    """r past MAX_R: the gathered pairs sorted in device memory (runs of
    8,192, then merge passes), with and without the magnitudes, against
    the plain version; still one launch of each of the report's two."""
    kinds = ["one_binade", "mostly_nan"] if n == 2 else ["ties"]
    G = torch.from_numpy(_rows(kinds, d, seed=r))
    want = RP.threshold_topk_batch_plain(G, r).numpy()
    before = dict(build.LAUNCHES)
    got = RP.threshold_topk_batch(G.to(cuda), r)
    rose = {k: build.LAUNCHES[k] - before[k] for k in before}
    assert rose == {**{k: 0 for k in before}, "maghist_batch": 1,
                    "threshold_topk_batch": 1}
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    vals, idx = RP.threshold_topk_batch(G.to(cuda), r, vals=True)
    np.testing.assert_array_equal(idx.cpu().numpy(), want)
    m = torch.where(torch.isnan(G), -1.0, G.abs())
    np.testing.assert_array_equal(vals.cpu().numpy(),
                                  m.gather(1, torch.from_numpy(want).long())
                                  .numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,r", [(10, 39_760, 75), (6, 2_515_338, 2500),
                                   (1, 39_760, 75)])
def test_baselines_report_kernel_matches_cpu(cuda, n, d, r):
    """``ops.threshold_topk`` on the card (the candidate report's two
    launches with its magnitudes, no ``maghist``) against the CPU's
    (per-block histograms and a stable sort), vals and indices exactly, at
    fig3 and CIFAR and on one vector."""
    G = torch.from_numpy(_rows(KINDS[:n], d, seed=d))
    if n == 1:
        G = G[0]
    before = dict(build.LAUNCHES)
    got = ops.threshold_topk(G.to(cuda), r)
    rose = {k: build.LAUNCHES[k] - before[k] for k in before}
    assert rose == {**{k: 0 for k in before}, "maghist_batch": 1,
                    "threshold_topk_batch": 1}
    for a, b in zip(got, ops.threshold_topk(G, r)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("C,S,r,k", [(1, 156, 75, 10), (1, 256, 75, 10),
                                     (1, 6, 2500, 100), (2, 170, 120, 100),
                                     (1, 2, 10_000, 50)])
@pytest.mark.parametrize("disjoint", [True, False])
def test_segmented_kernel_past_one_block(cuda, C, S, r, k, disjoint):
    """Clusters that one block's shared memory cannot hold (the hash in
    device memory at (2, 170, 120, 100); a member past 8,192 lanes at
    (1, 2, 10,000, 50)), with int32 and the engine's int64 candidates and
    a -1 candidate, against the plain version exactly."""
    assert ST.layout(S, r, k)["path"] == "global"
    cand, age, valid = _segment_inputs(C, S, r, seed=S + r)
    cand[:, -1, 0] = -1
    want = ST.segmented_age_topk_plain(
        *(torch.from_numpy(a) for a in (cand, age, valid)), k,
        disjoint=disjoint)
    for dtype in (torch.int32, torch.int64):
        got = ST.segmented_age_topk(
            torch.from_numpy(cand).to(cuda, dtype),
            torch.from_numpy(age).to(cuda), torch.from_numpy(valid).to(cuda),
            k, disjoint=disjoint)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_report_kernel_rereads_a_full_range(cuda):
    """Past d = 3.1M a block's range gives each warp over 192 rows; on a
    row of one value every row holds survivors, so the warps read their
    whole ranges again instead of their noted rows."""
    d = 3_300_000
    G = torch.from_numpy(_rows(["one_value", "one_binade", "normal"], d,
                               seed=3))
    got = ops.threshold_topk_batch(G.to(cuda), 300)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ops.threshold_topk_batch(G, 300).numpy())


@pytest.mark.cuda
def test_report_kernel_at_the_cifar_shape(cuda):
    """The CIFAR report: 6 rows of the CNN's d = 2,515,338, r = 2,500, rows
    of one binade and of one value among them."""
    d, r = 2_515_338, 2500
    G = torch.from_numpy(_rows(["normal", "one_binade", "one_value", "ties",
                                "specials", "half_zero"], d, seed=5))
    got = ops.threshold_topk_batch(G.to(cuda), r)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ops.threshold_topk_batch(G, r).numpy())
