"""The port's selection strategies against ``repro.core.strategies``.

The deterministic methods (dense, top-k, rAge-k with and without an
exclude mask, CAFe) must give exactly the reference's indices, values and
new state on the same numpy inputs, one vector through ``select`` and the
(N, d) batch through ``select_batch``, with magnitude and age ties. CAFe's
score follows the reference's jitted program, which rounds
``age - lam * cost`` once. torch's generators cannot reproduce threefry,
so rTop-k and random-k are held to their semantics: k distinct indices,
drawn from the top-r candidates (rTop-k) or from all of d (random-k),
uniformly (a chi-square test over many draws), and the same draw from the
same seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

from scipy import stats

from repro.core import strategies as JS

from repro_torch.core import strategies as TS


def _inputs(n, d, seed, *, ties=True):
    """Gradients with magnitude ties, ages and costs with few values."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d)).astype(np.float32)
    if ties:
        G = (np.round(G * 4) / 4).astype(np.float32)
    age = rng.integers(0, 4, (n, d)).astype(np.int32)
    cost = rng.integers(0, 3, (n, d)).astype(np.int32)
    return G, age, cost


def _check(got, want):
    """(idx, vals, state) of the port against the reference, exactly."""
    t_idx, t_vals, t_state = got
    j_idx, j_vals, j_state = want
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(j_vals))
    t_leaves = t_state if isinstance(t_state, tuple) else (t_state,)
    j_leaves = j_state if isinstance(j_state, tuple) else (j_state,)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _pair(method, **kw):
    return (JS.make_strategy(method, **kw), TS.make_strategy(method, **kw))


def _state(method, age, cost):
    if method == "rage_k":
        return age
    if method == "cafe":
        return (age, cost)
    return ()


@pytest.mark.parametrize("method,kw", [
    ("dense", {}), ("top_k", dict(k=7)),
    ("rage_k", dict(r=30, k=7, candidates="sort")),
    ("rage_k", dict(r=30, k=7, candidates="threshold")),
    ("cafe", dict(r=30, k=7, lam=0.0, candidates="threshold")),
    ("cafe", dict(r=30, k=7, lam=5.0, candidates="sort")),
    ("cafe", dict(r=30, k=7, lam=5.0, candidates="threshold"))])
def test_deterministic_strategy_matches_reference(method, kw):
    G, age, cost = _inputs(4, 500, seed=len(method) + kw.get("k", 0))
    js, ts = _pair(method, **kw)
    # one vector
    j_state = jax.tree_util.tree_map(jnp.asarray, _state(method, age[0],
                                                         cost[0]))
    t_state = jax.tree_util.tree_map(torch.from_numpy,
                                     _state(method, age[0], cost[0]))
    _check(ts.select(torch.from_numpy(G[0]), t_state),
           js.select(jnp.asarray(G[0]), j_state))
    # the batch
    j_state = jax.tree_util.tree_map(jnp.asarray, _state(method, age, cost))
    t_state = jax.tree_util.tree_map(torch.from_numpy,
                                     _state(method, age, cost))
    _check(ts.select_batch(torch.from_numpy(G), t_state),
           js.select_batch(jnp.asarray(G), j_state))


@pytest.mark.parametrize("candidates", ["sort", "threshold"])
def test_rage_k_exclude_matches_reference(candidates):
    G, age, _ = _inputs(1, 400, seed=3)
    rng = np.random.default_rng(5)
    exclude = rng.random(400) < 0.3
    js, ts = _pair("rage_k", r=40, k=9, candidates=candidates)
    _check(ts.select(torch.from_numpy(G[0]), torch.from_numpy(age[0]),
                     torch.from_numpy(exclude)),
           js.select(jnp.asarray(G[0]), jnp.asarray(age[0]),
                     jnp.asarray(exclude)))


def test_cafe_score_rounds_once_as_the_jitted_reference():
    """lam = 0.1 is inexact in float32: age 1, cost 10 scores 1 - 1.0 = 0
    if lam * cost is rounded first, -1.49e-8 in one rounding. The engine
    runs the reference jitted, which rounds once; so does the port."""
    js, ts = _pair("cafe", r=4, k=2, lam=0.1)
    g = np.asarray([4.0, 3.0, 2.0, 1.0, 0.5], np.float32)
    age = np.asarray([1, 0, 0, 0, 0], np.int32)
    cost = np.asarray([10, 0, 0, 0, 0], np.int32)
    want = jax.jit(js.select)(jnp.asarray(g), (jnp.asarray(age),
                                               jnp.asarray(cost)))
    got = ts.select(torch.from_numpy(g), (torch.from_numpy(age),
                                          torch.from_numpy(cost)))
    assert np.asarray(want[0]).tolist() == [1, 2]
    _check(got, want)
    # and on a batch with ages and costs that make such near-ties common
    G, age, cost = _inputs(6, 300, seed=11)
    age, cost = age * 3, cost * 10
    want = jax.jit(js.select_batch)(jnp.asarray(G), (jnp.asarray(age),
                                                     jnp.asarray(cost)))
    _check(ts.select_batch(torch.from_numpy(G), (torch.from_numpy(age),
                                                  torch.from_numpy(cost))),
           want)


@pytest.mark.parametrize("candidates", ["sort", "threshold"])
def test_topr_candidates_matches_reference(candidates):
    G, _, _ = _inputs(3, 9000, seed=9)
    for g in G:
        np.testing.assert_array_equal(
            TS.topr_candidates(torch.from_numpy(g), 75, candidates).numpy(),
            np.asarray(JS.topr_candidates(jnp.asarray(g), 75, candidates)))
    got = TS.topr_candidates(torch.from_numpy(G), 75, candidates)
    assert got.dtype == torch.int32 and got.shape == (3, 75)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JS.client_candidates(jnp.asarray(G), 75,
                                                     candidates)))


def test_make_strategy_round_trips_names():
    for name in TS.STRATEGIES:
        js, ts = _pair(name, r=10, k=3, lam=0.5, candidates="threshold")
        assert ts.name == js.name == name
        assert type(ts).__name__ == type(js).__name__
        if hasattr(js, "r"):
            assert (ts.r, ts.candidates) == (10, "threshold")
        if hasattr(js, "lam"):
            assert ts.lam == 0.5
    assert TS.STRATEGIES == JS.STRATEGIES
    with pytest.raises(ValueError, match="unknown method"):
        TS.make_strategy("nope", r=4, k=2)
    with pytest.raises(ValueError, match="candidates"):
        TS.make_strategy("rage_k", r=4, k=2, candidates="heap")


def test_age_select_ties_go_to_larger_magnitude():
    cand = torch.tensor([7, 3, 9, 1, 4])
    sel, idx = TS.age_select(cand, torch.tensor([2, 5, 5, -1, 2]), 3)
    assert sel.tolist() == [1, 2, 0] and idx.tolist() == [3, 9, 7]


# -- the stochastic baselines, by their properties --------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("candidates", ["sort", "threshold"])
def test_rtop_k_draws_k_distinct_candidates(candidates):
    G, _, _ = _inputs(64, 700, seed=2, ties=False)
    s = TS.RTopK(r=40, k=8, candidates=candidates)
    Gt = torch.from_numpy(G)
    idx, vals, gen = s.select_batch(Gt, _gen(0))
    assert idx.shape == (64, 8) and idx.dtype == torch.int32
    cand = TS.topr_candidates(Gt, 40, candidates).numpy()
    for i in range(64):
        assert len(set(idx[i].tolist())) == 8
        assert set(idx[i].tolist()) <= set(cand[i].tolist())
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(G, idx.numpy(), 1))
    assert isinstance(gen, torch.Generator)
    one, _, _ = s.select(Gt[5], _gen(1))
    assert one.shape == (8,) and set(one.tolist()) <= set(cand[5].tolist())


@pytest.mark.parametrize("method", ["rtop_k", "random_k"])
def test_stochastic_draws_repeat_from_the_seed(method):
    G, _, _ = _inputs(8, 300, seed=4, ties=False)
    s = TS.make_strategy(method, r=30, k=6, candidates="threshold")
    Gt = torch.from_numpy(G)
    a = s.select_batch(Gt, _gen(7))[0]
    b = s.select_batch(Gt, _gen(7))[0]
    c = s.select_batch(Gt, _gen(8))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        s.select_batch(Gt, None)


@pytest.mark.parametrize("method,n_pos,k", [("rtop_k", 20, 5),
                                            ("random_k", 30, 4)])
def test_stochastic_draws_are_uniform(method, n_pos, k):
    """Each of the n_pos positions (candidate ranks for rTop-k, indices
    for random-k) is drawn k / n_pos of the time: chi-square over 4000
    draws, rejected below p = 1e-3 (seeded, so the test is fixed)."""
    rows = 4000
    rng = np.random.default_rng(0)
    g = (rng.permutation(n_pos) + 1.0).astype(np.float32)
    G = torch.from_numpy(np.tile(g, (rows, 1)))
    s = TS.make_strategy(method, r=n_pos, k=k, candidates="sort")
    idx = s.select_batch(G, _gen(3))[0].numpy()
    assert all(len(set(r)) == k for r in idx)
    counts = np.bincount(idx.reshape(-1), minlength=n_pos)
    assert counts.sum() == rows * k
    p = stats.chisquare(counts, np.full(n_pos, rows * k / n_pos)).pvalue
    assert p > 1e-3, (p, counts)
