"""The port's participation and compute planes and error feedback against
the JAX package.

1. The schedulers: ``AoIBalanced``'s plans equal the reference's for the
   same AoI; ``Deadline``'s active mask, staleness and weights equal the
   reference's for the same round times; ``UniformM`` has m members and
   is a function of (seed, rnd); ``LatencyModel`` recomputes any draw,
   is exactly 1.0 in the degenerate case and draws with its stated
   log-mean and spread.
2. The pieces: ``draw_gathered`` gives ``draw``'s rows; masked
   ``rage_select`` and segmented selection equal the reference's (a
   fully inactive cluster keeps aging); error feedback,
   ``clip_by_global_norm`` and ``cosine_schedule``.
3. One fig3 round under a plan handed to both engines (the reference's
   scheduler replaced by one that returns it), from the reference's
   initial params and batches, for rAge-k (segmented and scan), CAFe,
   top-k and dense, masked and gathered, with and without error
   feedback, and with the SGD global optimizer: requested indices, ages
   and request counts exactly; losses (NaN outside the round), the new
   global params and the ef memory within rtol=1e-5, atol=1e-6. rTop-k
   draws from torch's generator, so there the picks must lie inside the
   reference's report.
4. The port alone: a partial run stepped equals ``run_scanned``
   bitwise; ``Full`` equals an all-active uniform plan bitwise; gathered
   equals masked bitwise for the MLP; the AoI-balanced peak stays at
   ceil(N/m).
"""
import math

import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

import jax
import jax.numpy as jnp
from repro.configs.base import RAgeKConfig as JCfg
from repro.core import strategies as JS
from repro.fl import client as JC
from repro.fl import engine as JE
from repro.fl import latency as JL
from repro.fl import schedule as JSch
from repro.optim import error_feedback as JEF
from repro.optim import optimizers as JO

from repro_torch.configs.base import RAgeKConfig
from repro_torch.data.federated import paper_mnist_split
from repro_torch.data.pipeline import DeviceShardStore
from repro_torch.data.synthetic import mnist_like
from repro_torch.fl import client as TC
from repro_torch.fl import engine as TE
from repro_torch.fl import latency as TL
from repro_torch.fl import schedule as TSch
from repro_torch.fl.engine import FederatedEngine
from repro_torch.optim import error_feedback as TEF
from repro_torch.optim import optimizers as TO
from repro_torch.weights import params_from_jax

FIG3 = dict(r=75, k=10, H=4, M=20, lr=1e-4, batch_size=256)
PAIRS = [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]
TOL = dict(rtol=1e-5, atol=1e-6)
# a uniform-style partial plan of bound m 5 with 4 clients (the fifth
# slot padded): in label pairs, cluster 2 has both members, clusters 0
# and 4 one, clusters 1 and 3 none
UNIFORM_ACT = [0, 1, 0, 0, 1, 1, 0, 0, 1, 0]
UNIFORM_M = 5
# a deadline-style plan: clients 3 and 6 late, 2 and 7 land one round
# stale at half weight
DEADLINE_ACT = [1, 1, 1, 0, 1, 1, 0, 1, 1, 1]
DEADLINE_STALE = [0, 0, 1, 0, 0, 0, 0, 1, 0, 0]


@pytest.fixture(scope="module")
def fig3_data():
    (x, y), test = mnist_like(n_train=3000, n_test=2000, seed=0)
    return paper_mnist_split(x, y, seed=0), test


# ---------------------------------------------------------------------------
# 1. the schedulers and the latency model
# ---------------------------------------------------------------------------


def _tstate(n, *, seed=0, rnd=0, aoi=None):
    return TSch.SchedState(
        seed=torch.tensor(seed, dtype=torch.int64),
        rnd=torch.tensor(rnd, dtype=torch.int32),
        aoi=torch.zeros(n, dtype=torch.int32) if aoi is None
        else torch.tensor(aoi, dtype=torch.int32))


@pytest.mark.parametrize("aoi,m", [
    ([0, 0, 0, 0, 0, 0], 2), ([3, 1, 3, 0, 2, 3], 2),
    ([5, 5, 1, 5, 0, 2, 5, 5], 3), ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 4)])
def test_aoi_plans_equal_reference(aoi, m):
    n = len(aoi)
    want = JSch.AoIBalanced(n, m).plan(JSch.SchedState(
        key=jax.random.PRNGKey(0), rnd=jnp.int32(0),
        aoi=jnp.asarray(aoi, jnp.int32)))
    got = TSch.AoIBalanced(n, m).plan(_tstate(n, aoi=aoi))
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    assert got.m == want.m == m
    assert not got.staleness.any() and torch.equal(got.weight,
                                                   torch.ones(n))


class _TableLatency:
    """Round times from a table, for the port's and the reference's
    ``Deadline`` alike."""

    def __init__(self, times, lib):
        self.times, self.lib = np.asarray(times, np.float32), lib

    def round_s(self, key, rnd):
        if self.lib is torch:
            return torch.from_numpy(self.times)[rnd.to(torch.int64)]
        return jnp.asarray(self.times)[rnd]


def test_deadline_plans_equal_reference_for_the_same_times():
    n, rounds = 8, 6
    times = np.random.default_rng(3).lognormal(0, 0.6, (rounds, n))
    jd = JSch.Deadline(n, 1.0, seed=1)
    object.__setattr__(jd, "latency", _TableLatency(times, jnp))
    td = TSch.Deadline(n, 1.0, device="cpu",
                       latency=_TableLatency(times, torch))
    seen_stale = False
    for rnd in range(rounds):
        want = jd.plan(JSch.SchedState(key=jax.random.PRNGKey(0),
                                       rnd=jnp.int32(rnd),
                                       aoi=jnp.zeros(n, jnp.int32)))
        got = td.plan(_tstate(n, rnd=rnd))
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert got.weight.dtype == torch.float32
        seen_stale |= bool(got.staleness.any())
    assert seen_stale


def test_deadline_with_the_reference_base_times():
    """Handed the reference's base times with no jitter, the port's
    round times, and so its plans, are the reference's."""
    n = 12
    jlat = JL.LatencyModel(n, hetero=0.5, jitter=0.0, seed=4)
    tlat = TL.LatencyModel(n, hetero=0.5, jitter=0.0, device="cpu",
                           base_s=np.asarray(jlat.base_s))
    key = jax.random.PRNGKey(0)
    for rnd in (0, 3):
        np.testing.assert_array_equal(
            tlat.round_s(0, torch.tensor(rnd)).numpy(),
            np.asarray(jlat.round_s(key, rnd)))
    jd = JSch.Deadline(n, 1.0, jitter=0.0, seed=4)
    td = TSch.Deadline(n, 1.0, device="cpu", latency=tlat)
    want = jd.plan(JSch.SchedState(key=key, rnd=jnp.int32(2),
                                   aoi=jnp.zeros(n, jnp.int32)))
    got = td.plan(_tstate(n, rnd=2))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # with no jitter a late client is late every round: it lands stale
    assert got.staleness.any() and not got.staleness.all()


@pytest.mark.parametrize("n,m", [(10, 2), (10, 5), (32, 8)])
def test_uniform_cardinality_and_determinism(n, m):
    sched = TSch.UniformM(n, m)
    counts = np.zeros(n)
    masks = []
    for rnd in range(400):
        a = sched.plan(_tstate(n, seed=7, rnd=rnd)).active
        assert int(a.sum()) == m
        assert torch.equal(a, sched.plan(_tstate(n, seed=7, rnd=rnd)).active)
        counts += a.numpy()
        masks.append(a)
    assert len({tuple(a.tolist()) for a in masks}) >= min(math.comb(n, m),
                                                           150)
    # each client's share of 400 rounds within 5 sigma of 400 m / n
    p = m / n
    assert np.abs(counts - 400 * p).max() < 5 * np.sqrt(400 * p * (1 - p))
    other = sched.plan(_tstate(n, seed=8, rnd=0)).active
    assert int(other.sum()) == m


def test_latency_model_recomputable_degenerate_and_moments():
    lat = TL.LatencyModel(6, hetero=0.7, jitter=0.4, seed=1, device="cpu")
    a = lat.dispatch_s(9, 2, 5)
    assert torch.equal(lat.dispatch_s(9, 2, 5), a)
    assert not torch.equal(lat.dispatch_s(9, 2, 6), a)
    assert not torch.equal(lat.dispatch_s(9, 3, 5), a)
    r4 = lat.round_s(9, torch.tensor(4, dtype=torch.int32))
    assert torch.equal(lat.round_s(9, 4), r4)
    assert not torch.equal(lat.round_s(9, 5), r4)
    walls = lat.sync_round_s(9, 5)
    for t in range(5):
        assert float(walls[t]) == max(float(lat.dispatch_s(9, i, t))
                                      for i in range(6))
    one = TL.LatencyModel(5, hetero=0.0, jitter=0.0, seed=3, device="cpu")
    assert torch.equal(one.base_s, torch.ones(5))
    assert torch.equal(one.round_s(3, 7), torch.ones(5))
    assert torch.equal(one.sync_round_s(3, 4), torch.ones(4))
    big = TL.LatencyModel(20_000, hetero=0.5, jitter=0.25, seed=2,
                          device="cpu")
    z = torch.log(big.base_s) / 0.5
    assert abs(float(z.mean())) < 0.04 and abs(float(z.std()) - 1) < 0.03
    z = torch.log(big.round_s(5, 11) / big.base_s) / 0.25
    assert abs(float(z.mean())) < 0.04 and abs(float(z.std()) - 1) < 0.03


def test_make_scheduler_defaults_and_validation():
    s = TSch.make_scheduler("uniform", 10, device="cpu")
    assert (s.name, s.m_bound) == ("uniform", 2)
    assert TSch.make_scheduler("aoi", 10, participation_m=3,
                               device="cpu").m_bound == 3
    d = TSch.make_scheduler("deadline", 10, device="cpu")
    assert (d.name, d.m_bound, d.deadline_s) == ("deadline", 10, 1.0)
    assert isinstance(d, TSch.Scheduler)
    with pytest.raises(ValueError, match="schedule"):
        TSch.make_scheduler("sometimes", 10, device="cpu")
    with pytest.raises(ValueError, match="1 <= m <= N"):
        TSch.UniformM(4, 5)


# ---------------------------------------------------------------------------
# 2. the pieces
# ---------------------------------------------------------------------------


def test_draw_gathered_equals_draw_rows(fig3_data):
    """Over several wraps: the listed rows' batches and sampler rows are
    ``draw``'s, the others are untouched, and a padded slot writes
    nothing."""
    shards, _ = fig3_data
    full = DeviceShardStore(shards, 64, seed=3, device="cpu")
    part = DeviceShardStore(shards, 64, seed=3, device="cpu")
    sf = full.init_state()
    sp = part.init_state()
    idx = torch.tensor([1, 4, 7, 10])          # the last slot padded
    rows = idx[:3]
    for _ in range(6):
        bx, by, sf2 = full.draw(full.data, sf, 3)
        gx, gy, sp2 = part.draw_gathered(part.data, sp, 3, idx)
        assert gx.shape == (4,) + bx.shape[1:]
        assert torch.equal(gx[:3], bx[rows]) and torch.equal(gy[:3], by[rows])
        held = torch.ones(10, dtype=torch.bool)
        held[rows] = False
        for a, b, old in zip(sp2, sf2, sp):
            assert torch.equal(a[rows], b[rows])
            assert torch.equal(a[held], old[held])
        sf = sp = sp2


def _jage(ca, freq, cl):
    return JE.DeviceAgeState(jnp.asarray(ca), jnp.asarray(freq),
                             jnp.asarray(cl, jnp.int32))


def _tage(ca, freq, cl):
    return TE.DeviceAgeState(torch.from_numpy(ca), torch.from_numpy(freq),
                             torch.tensor(cl, dtype=torch.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_selection_equals_reference(seed):
    """Both selection planes under a partial mask, with label-pair
    clusters, one of them with no active member: indices, ages and
    counts equal the reference's."""
    rng = np.random.default_rng(seed)
    n, d, r, k = 10, 300, 24, 5
    g = rng.standard_normal((n, d)).astype(np.float32)
    ca = rng.integers(0, 6, (n, d)).astype(np.int32)
    freq = rng.integers(0, 3, (n, d)).astype(np.int32)
    active = np.array(UNIFORM_ACT, bool)
    if seed:
        active = rng.random(n) < 0.5
    cands = np.asarray(JS.client_candidates(jnp.asarray(g), r))
    jidx, jnew = JE.rage_select(jnp.asarray(g), _jage(ca, freq, PAIRS), r=r,
                                k=k, active=jnp.asarray(active))
    ta = torch.from_numpy(active)
    cands = torch.from_numpy(cands.copy())
    tidx, tnew = TE.rage_select(_tage(ca, freq, PAIRS), k=k, cands=cands,
                                active=ta)
    sidx, snew, seg = TE.rage_select_segmented(
        _tage(ca, freq, PAIRS), r=r, k=k, cands=cands,
        d=d, num_segments=5, max_seg=2, active=ta)
    for idx, new in ((tidx, tnew), (sidx, snew)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(new.cluster_age.numpy(),
                                      np.asarray(jnew.cluster_age))
        np.testing.assert_array_equal(new.freq.numpy(), np.asarray(jnew.freq))
    assert (tidx.numpy()[~active] == d).all()
    assert (seg.idx[~(seg.members < n)] == d).all()


def test_fully_inactive_cluster_keeps_aging():
    n, d = 3, 8
    g = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    cands = torch.from_numpy(np.array(
        JS.client_candidates(jnp.asarray(g), 4)))
    active = torch.tensor([False, False, True])
    z = np.zeros((n, d), np.int32)
    for new in (TE.rage_select(_tage(z, z, [0, 0, 1]), k=1, cands=cands,
                               active=active)[1],
                TE.rage_select_segmented(_tage(z, z, [0, 0, 1]), r=4, k=1,
                                         cands=cands, d=d, num_segments=2,
                                         max_seg=1, active=active)[1]):
        assert (new.cluster_age[0] == 2).all()
        assert int(new.freq.sum()) == 1


def test_error_feedback_and_optimizer_helpers():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    mem = {"a": rng.standard_normal((3, 4)).astype(np.float32),
           "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    j = jax.tree_util.tree_map(jnp.asarray, (tree, mem))
    t = TC.tree_map(torch.from_numpy, tree), TC.tree_map(torch.from_numpy,
                                                         mem)
    for got, want in (
            (TEF.ef_init(t[0]), JEF.ef_init(j[0])),
            (TEF.ef_compensate(t[1], t[0]), JEF.ef_compensate(j[1], j[0])),
            (TEF.ef_update(t[1], t[0], t[1]),
             JEF.ef_update(j[1], j[0], j[1])),
            (TO.clip_by_global_norm(t[0], 0.5)[0],
             JO.clip_by_global_norm(j[0], 0.5)[0])):
        for a, b in zip(TC.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(
        float(TO.clip_by_global_norm(t[0], 0.5)[1]),
        float(JO.clip_by_global_norm(j[0], 0.5)[1]), **TOL)
    tf, jf = TO.cosine_schedule(0.1, 10, 100), JO.cosine_schedule(0.1, 10,
                                                                   100)
    steps = [0, 3, 10, 11, 50, 99, 100, 150]
    np.testing.assert_allclose(
        [float(tf(torch.tensor(s, dtype=torch.int32))) for s in steps],
        [float(jf(jnp.int32(s))) for s in steps], rtol=1e-6, atol=1e-9)
    # a schedule drives adam and sgd per client row, as in the reference
    g = rng.standard_normal((2, 6)).astype(np.float32)
    for topt, jopt in ((TO.adam(tf), JO.adam(jf)), (TO.sgd(tf), JO.sgd(jf))):
        st = topt.init(torch.zeros(2, 6), batch_dims=1)
        u, _ = topt.update(torch.from_numpy(g), st)
        ju, _ = jax.vmap(lambda gi, s: jopt.update(gi, s))(
            jnp.asarray(g), jax.vmap(jopt.init)(jnp.zeros((2, 6))))
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), **TOL)


# ---------------------------------------------------------------------------
# 3. one fig3 round under a handed-in plan, against the reference
# ---------------------------------------------------------------------------


class _FixedPlan:
    """The reference's scheduler protocol with one plan for every round."""

    name = "fixed"

    def __init__(self, n, m, plan):
        self.n, self._m, self._plan = n, m, plan

    @property
    def m_bound(self):
        return self._m

    def plan(self, state, age_state=None):
        return self._plan


def _plans(active, stale, m):
    n = len(active)
    act = np.asarray(active, bool)
    st = np.zeros(n, np.int32) if stale is None else np.asarray(stale,
                                                                np.int32)
    w = np.where(st > 0, 0.5, 1.0).astype(np.float32)
    jplan = JSch.RoundPlan(jnp.asarray(act), jnp.asarray(st), jnp.asarray(w),
                           m)
    tplan = TSch.RoundPlan(torch.from_numpy(act), torch.from_numpy(st),
                           torch.from_numpy(w), m)
    return jplan, tplan


def partial_rounds(kind, shards, test, hp, *, active, stale=None, m,
                   compute, selection="segmented", cluster_of=None,
                   rounds=1, ef=False, global_opt="adam", tol=TOL,
                   port_compute=None):
    """``rounds`` rounds of the reference engine (its scheduler replaced
    by one handed-in plan) and of the port's round body on the
    reference's initial params, model state and batches (gathered: the
    active rows', from ``draw_gathered``) under the same plan. Each
    round: losses and the new global params within ``tol``, picks, ages
    and counts exactly (rTop-k: inside the reference's report). Returns
    (jeng, teng, the port's last round)."""
    sched = "deadline" if m == len(active) else "uniform"
    jcfg = JCfg(**hp, schedule=sched, participation_m=m)
    jeng = JE.FederatedEngine(kind, shards, test, jcfg, seed=0,
                              selection=selection, compute=compute, ef=ef,
                              global_opt=global_opt)
    jplan, tplan = _plans(active, stale, m)
    jeng._scheduler = _FixedPlan(len(active), m, jplan)
    params0, state0 = jax.tree_util.tree_map(np.asarray,
                                             (jeng.g_params, jeng._state0))
    teng = FederatedEngine(kind, shards, test,
                           RAgeKConfig(**hp, schedule=sched,
                                       participation_m=m), seed=0,
                           device="cpu", selection=selection,
                           compute=port_compute or compute, ef=ef,
                           global_opt=global_opt,
                           params=params_from_jax(params0, "cpu"),
                           state=params_from_jax(state0, "cpu"))
    if cluster_of is not None:
        cl = np.asarray(cluster_of, np.int32)
        jeng.age = jeng.age._replace(cluster_of=jnp.asarray(cl))
        jeng._num_seg = teng._num_seg = int(cl.max()) + 1
        jeng._max_seg = teng._max_seg = int(np.bincount(cl).max())
        teng.age = teng.age._replace(cluster_of=torch.from_numpy(cl))
    n, d = len(active), teng.d
    act_idx = jnp.nonzero(jnp.asarray(active, bool), size=m,
                          fill_value=n)[0].astype(jnp.int32)
    gathered = (port_compute or compute) == "gathered"
    for _ in range(rounds):
        if gathered:
            bx, by, _ = jeng._store.draw_gathered(jeng._data, jeng.samp,
                                                  hp["H"], act_idx)
        else:
            bx, by, _ = jeng._store.draw(jeng._data, jeng.samp, hp["H"])
        jm = jeng.step()
        tm = teng._round_impl(torch.from_numpy(np.array(bx)),
                              torch.from_numpy(np.array(by)).long(), tplan)
        np.testing.assert_allclose(tm["losses"].numpy(), jm["losses"], **tol)
        assert np.isnan(tm["losses"].numpy()[~np.asarray(active, bool)]).all()
        if hp.get("method") != "rtop_k":       # the draws differ
            np.testing.assert_allclose(
                teng.g_params.numpy(),
                np.asarray(JC.flatten_tree(jeng.g_params)), **tol)
        if hp.get("method") == "rtop_k":
            report = np.asarray(JS.client_candidates(
                jnp.asarray(tm["G"].numpy()), hp["r"], "threshold"))
            got = tm["idx"].numpy()
            rows = np.asarray(act_idx)[np.asarray(act_idx) < n]
            for slot, i in enumerate(rows):
                assert set(got[i]) <= set(report[slot if gathered else i])
            assert (got[~np.asarray(active, bool)] == d).all()
        elif tm["idx"] is None:
            assert jm["idx"] is None
        else:
            np.testing.assert_array_equal(tm["idx"].numpy(), jm["idx"])
        np.testing.assert_array_equal(teng.age.cluster_age.numpy(),
                                      np.asarray(jeng.age.cluster_age))
        np.testing.assert_array_equal(teng.age.freq.numpy(),
                                      np.asarray(jeng.age.freq))
        for a, b in zip(TC.tree_leaves(teng.state_s),
                        jax.tree_util.tree_leaves(jeng.state_s)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
        if ef:
            np.testing.assert_allclose(teng.ef_mem.numpy(),
                                       np.asarray(jeng.ef_mem), **tol)
    return jeng, teng, tm


@pytest.mark.parametrize("method,selection,compute", [
    ("rage_k", "segmented", "gathered"), ("rage_k", "segmented", "masked"),
    ("rage_k", "scan", "gathered"), ("cafe", "segmented", "gathered"),
    ("dense", "segmented", "gathered"), ("rtop_k", "segmented",
                                         "gathered")])
def test_uniform_round_matches_reference(fig3_data, method, selection,
                                         compute):
    shards, test = fig3_data
    partial_rounds("mlp", shards, test, {**FIG3, "method": method},
                   active=UNIFORM_ACT, m=UNIFORM_M, compute=compute,
                   selection=selection,
                   cluster_of=PAIRS if method == "rage_k" else None)


@pytest.mark.parametrize("method,compute", [
    ("rage_k", "masked"), ("dense", "masked"), ("top_k", "gathered")])
def test_deadline_round_matches_reference(fig3_data, method, compute):
    """Late arrivals staleness-weighted, two clients out of the round."""
    shards, test = fig3_data
    partial_rounds("mlp", shards, test, {**FIG3, "method": method},
                   active=DEADLINE_ACT, stale=DEADLINE_STALE, m=10,
                   compute=compute,
                   cluster_of=PAIRS if method == "rage_k" else None)


def test_ef_rounds_match_reference(fig3_data):
    """Two gathered rAge-k rounds with error feedback: the second round's
    report ranks the gradients plus the first round's residual. (The
    masked path equals the gathered one bitwise, with ef:
    :func:`test_gathered_equals_masked`.)"""
    shards, test = fig3_data
    _, teng, _ = partial_rounds(
        "mlp", shards, test, FIG3, active=UNIFORM_ACT, m=UNIFORM_M,
        compute="gathered", cluster_of=PAIRS, rounds=2, ef=True)
    held = ~np.asarray(UNIFORM_ACT, bool)
    assert not teng.ef_mem.numpy()[held].any()
    assert teng.ef_mem.numpy()[~held].any()


def test_sgd_global_optimizer_matches_reference(fig3_data):
    shards, test = fig3_data
    _, teng, _ = partial_rounds(
        "mlp", shards, test, FIG3, active=[1] * 10, m=10, compute="masked",
        global_opt="sgd")
    assert teng.g_opt_state.nu is None and int(teng.g_opt_state.step) == 1


# ---------------------------------------------------------------------------
# 4. the port's drivers and planes
# ---------------------------------------------------------------------------

SMALL = dict(r=30, k=6, H=2, M=3, lr=2e-3, batch_size=16)


def _engine(shards, test, **kw):
    hp = {**SMALL, **kw.pop("hp", {})}
    return FederatedEngine("mlp", shards, test, RAgeKConfig(**hp), seed=3,
                           device="cpu", **kw)


def _buffers(eng):
    return [eng.g_params, *eng.g_opt_state, *eng.opt_s,
            *[t for t in eng.age if t is not None],
            *eng.samp, *eng.sched] + (
        [eng.ef_mem] if eng.ef_mem is not None else [])


def _same(ea, ra, eb, rb):
    assert ra.loss == rb.loss or np.array_equal(ra.loss, rb.loss)
    for key in ("rounds", "acc", "uplink_bytes", "n_active", "aoi_mean",
                "aoi_peak", "age_mean", "age_peak"):
        assert getattr(ra, key) == getattr(rb, key), key
    for a, b in zip(ra.requested, rb.requested):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ra.cluster_labels, rb.cluster_labels):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_buffers(ea), _buffers(eb)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hp,kw", [
    ({"schedule": "uniform", "participation_m": 2}, {}),
    ({"schedule": "aoi", "participation_m": 2}, {}),
    ({"schedule": "deadline"}, {}),
    ({"schedule": "uniform", "participation_m": 2}, {"ef": True}),
    ({"schedule": "uniform", "participation_m": 3, "method": "rtop_k"}, {})])
def test_partial_step_equals_run_scanned(fig3_data, hp, kw):
    shards, test = fig3_data
    ea, eb = _engine(shards, test, hp=hp, **kw), _engine(shards, test, hp=hp,
                                                         **kw)
    ra, rb = ea.run(5, eval_every=2), eb.run_scanned(5, eval_every=2)
    _same(ea, ra, eb, rb)
    if hp["schedule"] != "deadline":
        assert ra.n_active == [hp["participation_m"]] * 5
    else:
        assert any(0 < a < 10 for a in ra.n_active)
    for e in (ea, eb):
        e.close()


def test_full_equals_all_active_uniform(fig3_data):
    shards, test = fig3_data
    full = _engine(shards, test)
    rf = full.run(4, eval_every=2)
    for compute in ("auto", "gathered"):
        uni = _engine(shards, test, compute=compute,
                      hp={"schedule": "uniform", "participation_m": 10})
        assert uni._compute == ("masked" if compute == "auto"
                                else "gathered")
        _same(full, rf, uni, uni.run(4, eval_every=2))


@pytest.mark.parametrize("hp", [
    {"schedule": "uniform", "participation_m": 2},
    {"schedule": "aoi", "participation_m": 3, "method": "cafe"}])
def test_gathered_equals_masked(fig3_data, hp):
    """The MLP's gathered rounds are bitwise its masked rounds."""
    shards, test = fig3_data
    eg = _engine(shards, test, hp=hp, compute="gathered", ef=True)
    em = _engine(shards, test, hp=hp, compute="masked", ef=True)
    _same(eg, eg.run(4, eval_every=2), em, em.run(4, eval_every=2))


def test_aoi_peak_and_uplink(fig3_data):
    shards, test = fig3_data
    eng = _engine(shards, test, hp={"schedule": "aoi", "participation_m": 2})
    res = eng.run(12, eval_every=6)
    assert res.n_active == [2] * 12
    assert max(res.aoi_peak) <= 5
    assert res.uplink_bytes[-1] == 12 * 2 * eng._per_client_bytes
    # round-robin: every client heard from in rounds 1-5 and 6-10
    for r in (res.requested[:5], res.requested[5:10]):
        heard = [i for i in range(10) if any((q[i] < eng.d).all()
                                             for q in r)]
        assert heard == list(range(10))
