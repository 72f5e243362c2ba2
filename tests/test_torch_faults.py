"""The port's fault plane (``fl/faults.py`` and ``FederatedEngine``'s
``faults=``, ``quarantine=``, ``gate_bound=``) against the JAX package.

1. ``FaultModel`` on its own: ``parse`` accepts the reference's specs into
   the same fields and rejects what it rejects; the draws are functions of
   (key, coordinates) with independent lanes, p = 0 draws nothing and
   p = 1 everything, the dark set crashes every round and rates fall
   within binomial bounds; ``dispatch_fate`` is recomputable; ``corrupt``
   equals the reference's on the same rows exactly, and so does the
   report (rTop-k's and CAFe's) on corrupted rows.
2. One round against the reference from the reference's params and
   batches, with the same fault masks handed to both engines (each
   through a ``FaultModel`` subclass whose ``round_masks`` returns
   them), under the full plan and a handed-in uniform plan: rAge-k
   segmented and scan, CAFe, dense, top-k and rTop-k, masked and
   gathered, error feedback, the hierarchical layout, the gate on and
   off with Byzantine rows. Indices, ages, counts, the log, the AoI and
   the counters exactly; losses, params and the ef memory within rtol
   1e-5, atol 1e-6; rTop-k's picks inside the reference's report.
3. The port alone: an all-zero model is bitwise ``faults=None``; stepped
   equals ``run_scanned`` bitwise under faults, counters included; a
   dark client never lands; ``p_drop = 1`` freezes the global params;
   the NaN gate keeps them finite and without it they go NaN; Byzantine
   rows are quarantined; a model of another N raises; resume is bitwise
   under faults in both layouts.
"""
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
from repro.fl import faults as JF
from repro.fl import schedule as JSch

from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.configs.base import RAgeKConfig
from repro_torch.data.federated import paper_mnist_split
from repro_torch.data.synthetic import mnist_like
from repro_torch.fl import faults as TF
from repro_torch.fl import schedule as TSch
from repro_torch.fl.engine import FederatedEngine
from repro_torch.weights import params_from_jax

HP = dict(r=30, k=6, H=2, M=3, lr=2e-3, batch_size=16)
PAIRS = [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]
TOL = dict(rtol=1e-5, atol=1e-6)
N = 10


@pytest.fixture(scope="module")
def mnist_setup():
    (x, y), test = mnist_like(n_train=1200, n_test=400, seed=0)
    return paper_mnist_split(x, y, seed=0), test


# ---------------------------------------------------------------------------
# 1. FaultModel on its own
# ---------------------------------------------------------------------------

SPECS = ["nan:0.1,crash:0.05,drop:0.2,dark:0+3,byz:0.01,byz_scale:1e7",
         "inf:0.5", " crash:1 , dark:7 ,", "dark:", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_equals_reference(spec):
    want = JF.FaultModel.parse(spec, n=8, seed=5)
    got = TF.FaultModel.parse(spec, n=8, seed=5, device="cpu")
    for name in ("n", "p_crash", "p_nan", "p_inf", "p_byz", "p_drop",
                 "byz_scale", "dark", "seed", "any", "any_wire"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.dark_mask.numpy(),
                                  np.asarray(want.dark_mask))


@pytest.mark.parametrize("spec,kw,match", [
    ("gamma:0.1", {}, "unknown fault lane"),
    ("nan:1.5", {}, "not a probability"),
    (None, {"p_drop": -0.1}, "not a probability"),
    ("dark:7", {}, "dark ids out of range"),
    (None, {"n": 0}, "n >= 1")])
def test_rejects_what_the_reference_rejects(spec, kw, match):
    for make in (JF.FaultModel, lambda **a: TF.FaultModel(device="cpu",
                                                           **a)):
        with pytest.raises(ValueError, match=match):
            if spec is None:
                make(**{"n": 4, **kw})
            else:
                make.parse(spec, n=4) if make is JF.FaultModel else \
                    TF.FaultModel.parse(spec, n=4, device="cpu")


def _fm(**kw):
    return TF.FaultModel(device="cpu", **kw)


def test_draws_deterministic_and_lanes_independent():
    f = _fm(n=16, p_crash=0.5, p_nan=0.5)
    a = f.round_masks(3, torch.tensor(7, dtype=torch.int32))
    for x, y in zip(a, f.round_masks(3, 7)):
        assert torch.equal(x, y)
    c = f.round_masks(3, 8)
    assert any(not torch.equal(x, y) for x, y in zip(a, c))
    assert any(not torch.equal(x, y) for x, y in zip(a, f.round_masks(4, 7)))
    # another lane on, or another probability elsewhere, moves nothing
    g = _fm(n=16, p_crash=0.5, p_nan=0.5, p_drop=0.5, p_byz=0.2)
    b = g.round_masks(3, 7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # the lanes are not one draw: crash and nan disagree somewhere
    rounds = [f.round_masks(3, t) for t in range(20)]
    assert any(not torch.equal(m[0], m[1]) for m in rounds)


def test_p_zero_draws_nothing_p_one_everything_and_dark():
    f = _fm(n=12, p_nan=1.0, p_drop=1.0, dark=(2, 5))
    for t in range(30):
        crashed, nan, inf, byz, drop = f.round_masks(0, t)
        assert nan.all() and drop.all()
        assert not inf.any() and not byz.any()
        assert crashed.tolist() == [i in (2, 5) for i in range(12)]
    z = _fm(n=12)
    assert not z.any and not z.any_wire
    assert not any(m.any() for m in z.round_masks(0, 0))
    fate = f.dispatch_fate(0, torch.arange(12), torch.zeros(12))
    assert fate[0].tolist() == [i in (2, 5) for i in range(12)]
    assert fate[1].all() and not fate[2].any()


@pytest.mark.parametrize("p", [0.05, 0.3, 0.7])
def test_rates_within_binomial_bounds(p):
    n, rounds = 64, 200
    f = _fm(n=n, p_crash=p, p_nan=p, p_inf=p, p_byz=p, p_drop=p, seed=4)
    counts = np.zeros((5, n))
    for t in range(rounds):
        counts += np.stack([m.numpy() for m in f.round_masks(1, t)])
    sd = np.sqrt(rounds * p * (1 - p))
    # per client and lane within 5 sigma; the lane means within 5 sigma
    assert np.abs(counts - rounds * p).max() < 5 * sd
    assert np.abs(counts.mean(1) - rounds * p).max() < 5 * sd / np.sqrt(n)
    fates = np.stack([np.stack([m.numpy() for m in f.dispatch_fate(
        1, torch.arange(n), torch.full((n,), j))]) for j in range(rounds)])
    assert np.abs(fates.sum(0) - rounds * p).max() < 5 * sd


def test_dispatch_fate_recomputable():
    f = _fm(n=8, p_crash=0.5, p_byz=0.5, dark=(2,))
    a = f.dispatch_fate(0, torch.tensor([1]), torch.tensor([4]))
    b = f.dispatch_fate(0, torch.tensor(1), 4)
    assert all(bool(x) == bool(y) for x, y in zip(a, b))
    assert bool(f.dispatch_fate(0, torch.tensor(2), 0)[0])
    grid = f.dispatch_fate(0, torch.arange(8).view(-1, 1),
                           torch.arange(10).view(1, -1))
    for c, j in ((3, 0), (6, 9), (1, 4)):
        one = f.dispatch_fate(0, torch.tensor(c), torch.tensor(j))
        assert [bool(m[c, j]) for m in grid] == [bool(m) for m in one]
    # round and dispatch draws are different streams
    r = f.round_masks(0, 4)
    assert not all(torch.equal(r[k], grid[k][:, 4]) for k in (0, 3))


def test_corrupt_equals_reference():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((9, 40)).astype(np.float32)
    masks = rng.random((3, 9)) < 0.5
    masks[:, 0] = True                        # every lane on one row
    jf = JF.FaultModel(n=9, byz_scale=1e7)
    tf = _fm(n=9, byz_scale=1e7)
    want = np.asarray(jf.corrupt(jnp.asarray(g), *map(jnp.asarray, masks)))
    got = tf.corrupt(torch.from_numpy(g), *map(torch.from_numpy, masks))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want[0]).all()
    # one row and scalar masks (the service's landing)
    one = tf.corrupt(torch.from_numpy(g[1]), torch.tensor(False),
                     torch.tensor(False), torch.tensor(True))
    np.testing.assert_array_equal(one.numpy(), np.asarray(
        jf.corrupt(jnp.asarray(g[1]), jnp.asarray(False),
                   jnp.asarray(False), jnp.asarray(True))))


@pytest.mark.parametrize("d,r", [(300, 30), (5000, 75)])
def test_report_on_corrupted_rows_equals_reference(d, r):
    """rTop-k's and CAFe's report reads the corrupted rows: the port's
    report (``threshold_topk_batch`` and ``threshold_topk``) equals the
    reference's on whole NaN, +inf and -inf rows, Byzantine-scaled rows
    and rows with a few NaN and inf lanes."""
    from repro.kernels import ops as JOps
    from repro_torch.kernels import ops as TOps
    rng = np.random.default_rng(d)
    g = rng.standard_normal((6, d)).astype(np.float32)
    g[0] = np.nan
    g[1] = np.inf
    g[2] = -np.inf
    g[3] *= np.float32(1e8)
    g[4, rng.choice(d, 5, replace=False)] = np.nan
    g[4, rng.choice(d, 3, replace=False)] = np.inf
    np.testing.assert_array_equal(
        TOps.threshold_topk_batch(torch.from_numpy(g), r).numpy(),
        np.asarray(JOps.threshold_topk_batch(jnp.asarray(g), r)))
    for got, want in zip(TOps.threshold_topk(torch.from_numpy(g), r),
                         jax.vmap(lambda v: JOps.threshold_topk(v, r))(
                             jnp.asarray(g))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# 2. one round against the reference under handed-in masks
# ---------------------------------------------------------------------------

class _JMasks(JF.FaultModel):
    """The reference's FaultModel with fixed round masks."""

    def round_masks(self, key, rnd):
        return tuple(jnp.asarray(m) for m in self.masks)


class _TMasks(TF.FaultModel):
    """The port's FaultModel with fixed round masks."""

    def round_masks(self, key, rnd):
        return tuple(torch.from_numpy(m) for m in self.masks)


def _with_masks(cls, masks, **kw):
    f = cls(n=N, p_crash=0.5, p_nan=0.5, p_byz=0.5, p_drop=0.5,
            byz_scale=1e8, **kw)
    object.__setattr__(f, "masks", [np.asarray(m, bool) for m in masks])
    return f


def _mask(*ids):
    return [i in ids for i in range(N)]


# crash, nan, inf, byz, drop; with label pairs each cluster meets a lane
FULL_MASKS = [_mask(2), _mask(5), _mask(7), _mask(1), _mask(8)]
# a uniform-style plan of 6 (bound 7) and masks on and off it
UNIFORM_ACT = _mask(0, 1, 3, 4, 5, 8)
UNIFORM_M = 7
UNIFORM_MASKS = [_mask(4, 9), _mask(5), _mask(), _mask(1), _mask(8)]
# finite faults only, for the gate-off comparison
BYZ_MASKS = [_mask(2), _mask(), _mask(), _mask(1, 6), _mask(8)]


class _FixedPlan:
    """The reference's scheduler protocol with one plan for every round."""

    name = "fixed"

    def __init__(self, m, plan):
        self._m, self._plan = m, plan

    @property
    def m_bound(self):
        return self._m

    def plan(self, state, age_state=None):
        return self._plan


def faulted_round(setup, *, method="rage_k", selection="segmented",
                  compute="masked", masks=FULL_MASKS, active=None, m=N,
                  ef=False, layout="dense", quarantine=True):
    """The reference engine's first round and the port's round body from
    the reference's params and batches, both with ``masks`` handed in
    (and, with ``active``, the plan). Compares them and returns (jeng,
    jm, teng, tm)."""
    shards, test = setup
    hp = dict(HP, method=method, age_layout=layout, eps=0.8)
    sched = ({} if active is None
             else {"schedule": "uniform", "participation_m": m})
    jeng = JE.FederatedEngine(
        "mlp", shards, test, JCfg(**hp, **sched), seed=0,
        selection=selection, compute=compute, ef=ef,
        faults=_with_masks(_JMasks, masks), quarantine=quarantine)
    teng = FederatedEngine(
        "mlp", shards, test, RAgeKConfig(**hp, **sched), seed=0,
        device="cpu", selection=selection, compute=compute, ef=ef,
        faults=_with_masks(_TMasks, masks, device="cpu"),
        quarantine=quarantine,
        params=params_from_jax(jax.tree_util.tree_map(
            np.asarray, jeng.g_params), "cpu"))
    tplan = None
    act = np.ones(N, bool) if active is None else np.asarray(active, bool)
    if active is not None:
        st = np.zeros(N, np.int32)
        w = np.ones(N, np.float32)
        jeng._scheduler = _FixedPlan(m, JSch.RoundPlan(
            jnp.asarray(act), jnp.asarray(st), jnp.asarray(w), m))
        tplan = TSch.RoundPlan(torch.from_numpy(act), torch.from_numpy(st),
                               torch.from_numpy(w), m)
    if method == "rage_k":
        cl = np.asarray(PAIRS, np.int32)
        jeng.age = jeng.age._replace(cluster_of=jnp.asarray(cl))
        jeng._num_seg = teng._num_seg = 5
        jeng._max_seg = teng._max_seg = 2
        teng.age.cluster_of.copy_(torch.from_numpy(cl))
    crashed = np.asarray(masks[0], bool)
    run = act & ~crashed
    if compute == "gathered":
        act_idx = jnp.nonzero(jnp.asarray(run), size=m,
                              fill_value=N)[0].astype(jnp.int32)
        bx, by, _ = jeng._store.draw_gathered(jeng._data, jeng.samp,
                                              HP["H"], act_idx)
    else:
        bx, by, _ = jeng._store.draw(jeng._data, jeng.samp, HP["H"])
    jm = jeng.step()
    tm = teng._round_impl(torch.from_numpy(np.array(bx)),
                          torch.from_numpy(np.array(by)).long(), tplan)

    np.testing.assert_allclose(tm["losses"].numpy(), jm["losses"], **TOL)
    assert np.isnan(tm["losses"].numpy()[~run]).all()
    assert tm["faults"].tolist() == [jm["n_quarantined"], jm["n_crashed"],
                                     jm["n_dropped"]]
    assert int(tm["n_active"]) == jm["n_active"] == run.sum()
    np.testing.assert_array_equal(teng.sched.aoi.numpy(),
                                  np.asarray(jeng.sched.aoi))
    if method == "rtop_k":
        # the draws differ: the picks lie inside the reference's report
        rows = np.flatnonzero(run)
        G = tm["G"].numpy()
        report = np.asarray(JS.client_candidates(jnp.asarray(G), HP["r"],
                                                 "threshold"))
        got = tm["idx"].numpy()
        heard = got[:, 0] < teng.d
        np.testing.assert_array_equal(heard, jm["idx"][:, 0] < teng.d)
        for slot, i in enumerate(rows):
            if heard[i]:
                assert set(got[i]) <= set(
                    report[slot if compute == "gathered" else i])
    else:
        np.testing.assert_allclose(
            teng.g_params.numpy(),
            np.asarray(JC.flatten_tree(jeng.g_params)), **TOL)
        if jm["idx"] is None:
            assert tm["idx"] is None
        else:
            np.testing.assert_array_equal(tm["idx"].numpy(), jm["idx"])
        np.testing.assert_array_equal(teng.age.cluster_age.numpy(),
                                      np.asarray(jeng.age.cluster_age))
    for name in ("freq", "cost", "upload_cost", "log_idx", "log_mem",
                 "log_ptr"):
        a, b = getattr(teng.age, name), getattr(jeng.age, name)
        assert (a is None) == (b is None), name
        if a is not None and method != "rtop_k":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    if ef:
        np.testing.assert_allclose(teng.ef_mem.numpy(),
                                   np.asarray(jeng.ef_mem), **TOL)
    return jeng, jm, teng, tm


@pytest.mark.parametrize("method,selection,compute", [
    ("rage_k", "segmented", "masked"), ("rage_k", "scan", "gathered"),
    ("cafe", "segmented", "masked"), ("cafe", "segmented", "gathered"),
    ("dense", "segmented", "gathered"), ("top_k", "segmented", "masked"),
    ("rtop_k", "segmented", "masked")])
def test_full_plan_round_matches_reference(mnist_setup, method, selection,
                                           compute):
    _, jm, teng, tm = faulted_round(mnist_setup, method=method,
                                    selection=selection, compute=compute)
    # byz 1 and nan 5 quarantined (inf 7 too), 2 crashed, 8 dropped
    assert tm["faults"].tolist() == [3, 1, 1]
    if tm["idx"] is not None:
        heard = (tm["idx"].numpy() < teng.d).all(1)
        assert heard.tolist() == _mask(0, 3, 4, 6, 9)


@pytest.mark.parametrize("method,compute,ef", [
    ("rage_k", "gathered", True), ("rage_k", "masked", False),
    ("cafe", "gathered", False), ("dense", "masked", True)])
def test_uniform_plan_round_matches_reference(mnist_setup, method, compute,
                                              ef):
    _, _, _, tm = faulted_round(mnist_setup, method=method, compute=compute,
                                masks=UNIFORM_MASKS, active=UNIFORM_ACT,
                                m=UNIFORM_M, ef=ef)
    # crashed: 4 of the plan (9 is not in it); quarantined 1 and 5
    assert tm["faults"].tolist() == [2, 1, 1]


def test_hierarchical_round_matches_reference(mnist_setup):
    _, _, teng, _ = faulted_round(mnist_setup, layout="hierarchical")
    # the log's members are the clients that trained; the rows of those
    # the PS did not hear from hold the sentinel d
    mem = teng.age.log_mem[0].numpy()
    assert mem.tolist() == [0, 1, 3, 4, 5, 6, 7, 8, 9, N]


@pytest.mark.parametrize("method", ["rage_k", "cafe"])
def test_gate_off_byzantine_round_matches_reference(mnist_setup, method):
    """With the gate off the Byzantine rows land, scaled: the picks
    (CAFe's report ranks the scaled rows), ages and params still equal
    the reference's."""
    _, jm, _, tm = faulted_round(mnist_setup, method=method,
                                 masks=BYZ_MASKS, quarantine=False)
    assert tm["faults"].tolist() == [0, 1, 1]
    assert np.abs(tm["g_sum"].numpy()).max() > 1e3


# ---------------------------------------------------------------------------
# 3. the port alone
# ---------------------------------------------------------------------------

def _engine(setup, method="rage_k", **kw):
    shards, test = setup
    hp = RAgeKConfig(**HP, method=method,
                     age_layout=kw.pop("layout", "dense"), eps=0.8)
    return FederatedEngine("mlp", shards, test, hp, seed=3, device="cpu",
                           **kw)


def _buffers(eng):
    return [eng.g_params, *eng.g_opt_state, *eng.opt_s,
            *[t for t in eng.age if t is not None], *eng.samp, *eng.sched,
            *([eng.ef_mem] if eng.ef_mem is not None else [])]


def _same_runs(ea, ra, eb, rb):
    assert np.array_equal(ra.loss, rb.loss, equal_nan=True)
    for key in ("rounds", "acc", "uplink_bytes", "n_active", "aoi_peak",
                "age_peak", "n_quarantined", "n_crashed", "n_dropped"):
        assert getattr(ra, key) == getattr(rb, key), key
    for a, b in zip(ra.requested, rb.requested):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ra.cluster_labels, rb.cluster_labels):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_buffers(ea), _buffers(eb)):
        assert torch.equal(a, b)


FAULTS = dict(n=N, p_nan=0.2, p_crash=0.1, p_drop=0.1, seed=9)


@pytest.mark.parametrize("method,kw", [
    ("rage_k", {}), ("rage_k", {"compute": "gathered", "ef": True}),
    ("rtop_k", {}), ("cafe", {"layout": "hierarchical"})])
def test_all_zero_model_is_no_faults(mnist_setup, method, kw):
    ea = _engine(mnist_setup, method, **kw)
    eb = _engine(mnist_setup, method, faults=_fm(n=N), **kw)
    assert eb._faults is None
    _same_runs(ea, ea.run(4, eval_every=2), eb, eb.run(4, eval_every=2))


@pytest.mark.parametrize("method,kw", [
    ("rage_k", {}), ("rage_k", {"selection": "scan", "ef": True}),
    ("rage_k", {"layout": "hierarchical", "compute": "gathered"}),
    ("cafe", {}), ("rtop_k", {"compute": "gathered"}), ("dense", {}),
    ("random_k", {})])
def test_stepped_equals_run_scanned_under_faults(mnist_setup, method, kw):
    ea = _engine(mnist_setup, method, faults=_fm(**FAULTS), **kw)
    eb = _engine(mnist_setup, method, faults=_fm(**FAULTS), **kw)
    ra, rb = ea.run(7, eval_every=2), eb.run_scanned(7, eval_every=2)
    _same_runs(ea, ra, eb, rb)
    assert sum(ra.n_crashed) > 0 and sum(ra.n_quarantined) > 0
    assert sum(ra.n_dropped) > 0
    s = ra.summary()
    assert (s["total_crashed"], s["total_quarantined"]) == (
        sum(ra.n_crashed), sum(ra.n_quarantined))
    ea.close(), eb.close()


def test_dark_client_never_lands(mnist_setup):
    eng = _engine(mnist_setup, faults=_fm(n=N, dark=(4,)))
    res = eng.run(4, eval_every=4)
    assert res.n_crashed == [1] * 4 and res.n_active == [9] * 4
    for idx in res.requested:
        assert (idx[4] == eng.d).all()
    assert int(eng.sched.aoi[4]) == 4
    assert not eng.freq_matrix[4].any()


def test_drop_all_freezes_global_model(mnist_setup):
    eng = _engine(mnist_setup, faults=_fm(n=N, p_drop=1.0))
    p0, opt0 = eng.g_params.clone(), eng.opt_s.mu.clone()
    res = eng.run(3, eval_every=3)
    assert res.n_dropped == [N] * 3
    assert torch.equal(eng.g_params, p0)
    assert not torch.equal(eng.opt_s.mu, opt0)     # the clients trained


def test_nan_gate_on_and_off(mnist_setup):
    flt = _fm(n=N, p_nan=0.3, seed=2)
    on = _engine(mnist_setup, faults=flt)
    r_on = on.run(4, eval_every=2)
    assert sum(r_on.n_quarantined) > 0
    assert np.isfinite(r_on.loss).all()
    assert torch.isfinite(on.g_params).all()
    off = _engine(mnist_setup, faults=flt, quarantine=False)
    r_off = off.run(4, eval_every=4)
    assert r_off.n_quarantined == [0] * 4
    assert not torch.isfinite(off.g_params).all()


def test_byzantine_rows_quarantined(mnist_setup):
    eng = _engine(mnist_setup, faults=_fm(n=N, p_byz=1.0, byz_scale=1e8))
    p0 = eng.g_params.clone()
    res = eng.run(2, eval_every=2)
    assert res.n_quarantined == [N, N]
    assert torch.equal(eng.g_params, p0)
    loose = _engine(mnist_setup, faults=_fm(n=N, p_byz=1.0, byz_scale=1e8),
                    gate_bound=1e12)
    assert loose.run(1, eval_every=1).n_quarantined == [0]


def test_mismatched_fault_model_raises(mnist_setup):
    with pytest.raises(ValueError, match="FaultModel"):
        _engine(mnist_setup, faults=_fm(n=3))


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.FaultModel(n=4)


@pytest.mark.parametrize("layout", ["dense", "hierarchical"])
def test_resume_bitwise_under_faults(mnist_setup, tmp_path, layout):
    ref = _engine(mnist_setup, faults=_fm(**FAULTS), layout=layout)
    r_ref = ref.run_scanned(8, eval_every=2)
    a = _engine(mnist_setup, faults=_fm(**FAULTS), layout=layout)
    with AsyncCheckpointer(str(tmp_path)) as ck:
        a.run_scanned(4, eval_every=2, checkpointer=ck, ckpt_every=4)
    b = _engine(mnist_setup, faults=_fm(**FAULTS), layout=layout)
    res = b.load_state(str(tmp_path))
    assert b.round_idx == 4 and res.n_crashed == r_ref.n_crashed[:4]
    res = b.run(4, eval_every=2, result=res)
    _same_runs(ref, r_ref, b, res)
    assert sum(r_ref.n_quarantined) > 0
