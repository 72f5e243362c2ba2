"""The port's rAge-k candidate report and the steps of its kernels.

On the CPU ``ops.threshold_topk_batch`` runs its plain version; it is held
against the JAX package's ``threshold_topk_batch`` (both of its histogram
paths, the Pallas one in interpret mode) on rows made from a seed with
numpy: many equal magnitudes, one value, one binade, NaN, +/-inf, +/-0,
denormals, huge values, d not a multiple of the kernels' chunk, r = d and
fewer than r non-NaN values. ``report.threshold_topk_batch_steps`` repeats
the CUDA kernels' steps (block counts, compaction by block offsets, the
radix refine, the sort) and is pinned equal to the plain version with sort
buffers small enough that every branch runs. ``segmented_age_topk``'s
rank-then-walk steps (``segmented_age_topk_ranked``) are pinned to its
plain version, and the "fewer than k untaken lanes" cases to the Pallas
kernel. Everything compares exactly.

The tests marked ``cuda`` hold the kernels on the card against the plain
versions on the CPU, and skip where there is no card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp
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
    for S, r, k in ((1, 75, 10), (2, 75, 10), (1, 2500, 100), (2, 2500, 100),
                    (3, 7, 7), (4, 300, 5)):
        lay = ST.layout(S, r, k)
        assert lay["rp"] >= r and lay["rp"] & (lay["rp"] - 1) == 0
        assert lay["hash"] >= 2 * S * k and lay["hash"] & (lay["hash"] - 1) == 0
        assert 32 <= lay["threads"] <= 1024
        assert lay["smem"] <= ST.SMEM_LIMIT
    cand = torch.zeros((1, 8, 20_000), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        ST.segmented_age_topk(cand, cand, torch.ones((1, 8)), 10)


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
