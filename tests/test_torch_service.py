"""The port's async PS service (``fl/service.py``) and ``draw_one``.

1. The degenerate pin: at K = N, equal latencies and V = 1 the service is
   bitwise the port's engine (``run`` and ``run_scanned``) across the
   round-3 recluster, in both age layouts: losses, accuracies, uplink,
   requested indices, labels, params, ages and counts; landings in
   client-id order, fresh, a virtual second a round; the report mode's
   downlink billed k indices a dispatch.
2. Two flush windows against the reference's service, from its params,
   its base times (hetero 1.0, jitter 0: the order depends on them
   alone) and fixed per-client batches handed to both through a store
   stub, in report and dispatch modes: event order, staleness, clock,
   versions and requests exactly; losses and params within rtol 1e-5,
   atol 1e-6. The CIFAR CNN's service (Network-2 with its BatchNorm
   state, ``test_torch_cnn.py``'s sizes: 6 clients, r 200, k 20, H 1,
   batch 8) over one flush window the same way in dispatch mode: the
   solicited candidates, the selected indices, the ages and the window
   exactly; losses, params and BatchNorm state within rtol 1e-4, atol
   1e-6 (``test_torch_cnn.py``'s round tolerance: a backward through four
   BatchNorms).
3. The port alone: chunk invariance; the event order equals a host
   numpy replay of the port's own latency draws; a flush at exactly every
   K-th landing; V = 1 reads fresh; dispatch mode's disjoint
   solicitations and billing; constructor validation; ``draw_one``
   advances only its row and gives ``draw``'s row for the same count,
   whoever else drew; faults (counters, the dark client's backoff, the
   stall error); resume bitwise in both layouts.
"""
import contextlib

import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

import jax
import jax.numpy as jnp
from repro.configs.base import RAgeKConfig as JCfg
from repro.fl import client as JC
from repro.fl import latency as JL
from repro.fl import service as JSvc

from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.configs.base import RAgeKConfig
from repro_torch.core.compression import (bytes_per_index, bytes_per_round,
                                          downlink_bytes_per_round)
from repro_torch.data.federated import paper_cifar_split, paper_mnist_split
from repro_torch.data.pipeline import DeviceShardStore
from repro_torch.data.synthetic import cifar10_like, mnist_like
from repro_torch.fl import service as TSvc
from repro_torch.fl.engine import FederatedEngine
from repro_torch.fl.faults import FaultModel
from repro_torch.fl.latency import LatencyModel
from repro_torch.fl.service import AsyncService
from repro_torch.weights import params_from_jax

HP = dict(r=30, k=6, H=2, M=3, lr=2e-3, batch_size=16)
ROUNDS = 4      # crosses the round-3 recluster
TOL = dict(rtol=1e-5, atol=1e-6)
N = 10


@pytest.fixture(scope="module")
def mnist_setup():
    (x, y), test = mnist_like(n_train=1200, n_test=400, seed=0)
    return paper_mnist_split(x, y, seed=0), test


def _hp(**over):
    return RAgeKConfig(method="rage_k", **{**HP, **over})


# ---------------------------------------------------------------------------
# 1. the degenerate pin against the port's engine
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _one_thread():
    """One intra-op thread: a one-row GEMM split across threads rounds
    otherwise than a row of the engine's batched GEMM."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module", params=["dense", "hierarchical"])
def degenerate_pin(request, mnist_setup):
    shards, test = mnist_setup
    hp = _hp(age_layout=request.param, eps=0.8)
    engines = {}
    with _one_thread():
        for driver in ("run", "run_scanned"):
            eng = FederatedEngine("mlp", shards, test, hp, seed=0,
                                  device="cpu")
            engines[driver] = (eng, getattr(eng, driver)(ROUNDS,
                                                         eval_every=1))
            eng.close()
        svc = AsyncService("mlp", shards, test, hp, seed=0, device="cpu")
        return engines, svc, svc.run_async(ROUNDS, eval_every=1)


@pytest.mark.parametrize("driver", ["run", "run_scanned"])
def test_degenerate_pin(degenerate_pin, driver):
    engines, svc, sr = degenerate_pin
    eng, er = engines[driver]
    assert sr.rounds == er.rounds == list(range(1, ROUNDS + 1))
    assert sr.loss == er.loss and sr.acc == er.acc
    assert sr.uplink_bytes == er.uplink_bytes
    np.testing.assert_array_equal(
        np.stack(er.requested), np.stack(sr.requested).reshape(ROUNDS, N, -1))
    for a, b in zip(er.cluster_labels, sr.cluster_labels):
        np.testing.assert_array_equal(a, b)
    # the recluster at round 3 merged clusters
    assert len(set(sr.cluster_labels[-1].tolist())) < N
    assert torch.equal(eng.g_params, svc.state.g_params)
    assert torch.equal(eng.age.cluster_age, svc.age.cluster_age)
    np.testing.assert_array_equal(eng.freq_matrix, svc.freq_matrix)


def test_degenerate_event_discipline_and_billing(degenerate_pin):
    _, svc, sr = degenerate_pin
    assert sr.clients == list(range(N)) * ROUNDS
    assert max(sr.staleness) == 0
    assert sr.clock == [float(t) for t in range(1, ROUNDS + 1)]
    d, hp = svc.d, svc.hp
    events = len(sr.clients)
    assert sr.downlink_bytes[-1] == (N + events) * downlink_bytes_per_round(
        hp.k, d)
    assert sr.uplink_bytes[-1] == events * (
        bytes_per_round(hp.k, d, wire_dtype=hp.wire_dtype)
        + hp.r * bytes_per_index(d))


# ---------------------------------------------------------------------------
# 2. two flush windows against the reference's service
# ---------------------------------------------------------------------------

K_REF, V_REF = 5, 4


class _JStub:
    """The reference store's ``draw_one`` with fixed per-client batches."""

    def __init__(self, bx, by):
        self.bx, self.by = bx, by

    def draw_one(self, data, samp, H, i):
        return jnp.take(self.bx, i, axis=0), jnp.take(self.by, i, axis=0), samp


class _TStub:
    """The port store's ``draw_one`` with the same fixed batches."""

    def __init__(self, bx, by):
        self.bx, self.by = bx, by

    def draw_one(self, data, samp, H, i):
        return self.bx[i][0], self.by[i][0], samp


@pytest.fixture(scope="module")
def reference_windows(mnist_setup):
    shards, test = mnist_setup
    out = {}
    for mode in ("report", "dispatch"):
        hp = dict(HP, buffer_k=K_REF, version_window=V_REF,
                  staleness_eta=0.5)
        jlat = JL.LatencyModel(N, hetero=1.0, jitter=0.0, seed=0)
        jsvc = JSvc.AsyncService("mlp", shards, test,
                                 JCfg(method="rage_k", **hp), seed=0,
                                 latency=jlat, solicit=mode)
        bx, by, _ = jsvc._store.draw(jsvc._data, jsvc.state.samp, HP["H"])
        jsvc._store = _JStub(bx, by)
        params0 = jax.tree_util.tree_map(np.asarray, jsvc.state.g_params)
        jm = jsvc._advance(2 * K_REF)
        out[mode] = (hp, jlat, bx, by, params0, jsvc, jm)
    return out


@pytest.mark.parametrize("mode", ["report", "dispatch"])
def test_flush_windows_match_reference(mnist_setup, reference_windows, mode):
    shards, test = mnist_setup
    hp, jlat, bx, by, params0, jsvc, jm = reference_windows[mode]
    tsvc = AsyncService(
        "mlp", shards, test, _hp(**{k: v for k, v in hp.items()
                                    if k not in HP}),
        seed=0, device="cpu", solicit=mode,
        params=params_from_jax(params0, "cpu"),
        latency=LatencyModel(N, hetero=1.0, jitter=0.0, device="cpu",
                             base_s=np.asarray(jlat.base_s)))
    tsvc._store = _TStub(torch.from_numpy(np.array(bx)),
                         torch.from_numpy(np.array(by)).long())
    tm = tsvc._advance(2 * K_REF)
    for key in ("client", "staleness", "version", "flushed", "clock",
                "idx"):
        np.testing.assert_array_equal(tm[key], np.asarray(jm[key]), key)
    assert tm["flushed"].sum() == 2 and tm["staleness"].max() >= 1
    np.testing.assert_allclose(tm["loss"], np.asarray(jm["loss"]), **TOL)
    np.testing.assert_allclose(
        tsvc.state.g_params.numpy(),
        np.asarray(JC.flatten_tree(jsvc.state.g_params)), **TOL)
    for v in range(V_REF):
        np.testing.assert_allclose(
            tsvc.state.ring[v].numpy(), np.asarray(JC.flatten_tree(
                jax.tree_util.tree_map(lambda x: x[v], jsvc.state.ring))),
            **TOL)
    np.testing.assert_array_equal(tsvc.age.cluster_age.numpy(),
                                  np.asarray(jsvc.state.age.cluster_age))
    np.testing.assert_array_equal(tsvc.age.freq.numpy(),
                                  np.asarray(jsvc.state.age.freq))
    np.testing.assert_array_equal(tsvc.state.next_done.numpy(),
                                  np.asarray(jsvc.state.next_done))
    if mode == "dispatch":
        np.testing.assert_array_equal(tsvc.state.solicited.numpy(),
                                      np.asarray(jsvc.state.solicited))
        np.testing.assert_array_equal(tsvc.state.inflight.numpy(),
                                      np.asarray(jsvc.state.inflight))


CNN_HP = dict(r=200, k=20, H=1, M=2, lr=1e-3, batch_size=8)
CNN_TOL = dict(rtol=1e-4, atol=1e-6)
K_CNN, V_CNN, N_CNN = 4, 2, 6


@pytest.fixture(scope="module")
def cnn_reference():
    """One flush window of the reference's CNN service in dispatch mode,
    its batches fixed through the store stub."""
    (x, y), test = cifar10_like(n_train=600, n_test=240, seed=0)
    shards = paper_cifar_split(x, y, seed=0)
    hp = dict(CNN_HP, buffer_k=K_CNN, version_window=V_CNN,
              staleness_eta=0.5)
    jlat = JL.LatencyModel(N_CNN, hetero=1.0, jitter=0.0, seed=0)
    jsvc = JSvc.AsyncService("cnn", shards, test,
                             JCfg(method="rage_k", **hp), seed=0,
                             latency=jlat, solicit="dispatch")
    bx, by, _ = jsvc._store.draw(jsvc._data, jsvc.state.samp, CNN_HP["H"])
    jsvc._store = _JStub(bx, by)
    params0 = jax.tree_util.tree_map(np.asarray, jsvc.state.g_params)
    state0 = jax.tree_util.tree_map(np.asarray, jsvc._state0)
    sol0 = np.asarray(jsvc.state.solicited)
    jm = jsvc._advance(K_CNN)
    return shards, test, hp, jlat, bx, by, params0, state0, sol0, jsvc, jm


def test_cnn_flush_window_matches_reference(cnn_reference):
    shards, test, hp, jlat, bx, by, params0, state0, sol0, jsvc, jm = \
        cnn_reference
    tsvc = AsyncService(
        "cnn", shards, test, RAgeKConfig(method="rage_k", **hp), seed=0,
        device="cpu", solicit="dispatch",
        params=params_from_jax(params0, "cpu"),
        state=params_from_jax(state0, "cpu"),
        latency=LatencyModel(N_CNN, hetero=1.0, jitter=0.0, device="cpu",
                             base_s=np.asarray(jlat.base_s)))
    np.testing.assert_array_equal(tsvc.state.solicited.numpy(), sol0)
    tsvc._store = _TStub(torch.from_numpy(np.array(bx)),
                         torch.from_numpy(np.array(by)).long())
    tm = tsvc._advance(K_CNN)
    for key in ("client", "staleness", "version", "flushed", "clock",
                "idx"):
        np.testing.assert_array_equal(tm[key], np.asarray(jm[key]), key)
    assert tm["flushed"].tolist() == [False] * (K_CNN - 1) + [True]
    np.testing.assert_allclose(tm["loss"], np.asarray(jm["loss"]),
                               **CNN_TOL)
    np.testing.assert_allclose(
        tsvc.state.g_params.numpy(),
        np.asarray(JC.flatten_tree(jsvc.state.g_params)), **CNN_TOL)
    for v in range(V_CNN):
        np.testing.assert_allclose(
            tsvc.state.ring[v].numpy(), np.asarray(JC.flatten_tree(
                jax.tree_util.tree_map(lambda x: x[v], jsvc.state.ring))),
            **CNN_TOL)
    for name in ("cluster_age", "freq"):
        np.testing.assert_array_equal(
            getattr(tsvc.age, name).numpy(),
            np.asarray(getattr(jsvc.state.age, name)), name)
    for name in ("solicited", "inflight", "next_done"):
        np.testing.assert_array_equal(getattr(tsvc.state, name).numpy(),
                                      np.asarray(getattr(jsvc.state, name)),
                                      name)
    jstate = jsvc.state.state_s
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        got = tsvc.state.state_s
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got.numpy(), np.asarray(leaf),
                                   **CNN_TOL)


# ---------------------------------------------------------------------------
# 3. the port alone
# ---------------------------------------------------------------------------

def _prod_svc(mnist_setup, **over):
    shards, test = mnist_setup
    hp = _hp(buffer_k=over.pop("buffer_k", 4),
             version_window=over.pop("version_window", 4),
             staleness_eta=0.5, eps=0.8,
             age_layout=over.pop("layout", "dense"))
    lat = LatencyModel(N, hetero=1.0, jitter=0.25, seed=0, device="cpu")
    return AsyncService("mlp", shards, test, hp, seed=0, device="cpu",
                        latency=lat, **over)


def _same_state(a, b):
    for x, y in zip(_leaves(a.state), _leaves(b.state)):
        assert torch.equal(x, y)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    return [l for t in tree for l in _leaves(t)]


@pytest.mark.parametrize("solicit", ["report", "dispatch"])
def test_chunk_invariance(mnist_setup, solicit):
    a = _prod_svc(mnist_setup, solicit=solicit)
    ra = a.run_async(8, eval_every=3)
    b = _prod_svc(mnist_setup, solicit=solicit)
    rb1 = b.run_async(4, eval_every=3)
    rb2 = b.run_async(4, eval_every=3)
    assert ra.clients == rb1.clients + rb2.clients
    assert ra.staleness == rb1.staleness + rb2.staleness
    assert ra.event_clock == rb1.event_clock + rb2.event_clock
    assert ra.acc[-1] == rb2.acc[-1]
    _same_state(a, b)
    assert max(ra.staleness) <= a.V - 1 and max(ra.staleness) > 0


def test_event_order_matches_host_replay(mnist_setup):
    """The arrival order is a function of the latency draws alone: a
    numpy replay of the argmin loop (float32 clock, first-occurrence
    ties) gives the device's event stream."""
    svc = _prod_svc(mnist_setup)
    res = svc.run_async(3, eval_every=3)
    lat = svc._latency
    nd = np.zeros(N, np.int64)
    next_done = np.array([float(lat.dispatch_s(0, i, 0)) for i in range(N)],
                         np.float32)
    clients, clocks = [], []
    for _ in res.clients:
        i = int(np.argmin(next_done))
        t = next_done[i]
        clients.append(i)
        clocks.append(t)
        nd[i] += 1
        next_done[i] = np.float32(t + np.float32(float(
            lat.dispatch_s(0, i, int(nd[i])))))
    assert res.clients == clients
    np.testing.assert_array_equal(np.asarray(res.event_clock, np.float32),
                                  np.asarray(clocks, np.float32))


def test_flush_exactly_every_kth_landing_and_fresh_v1(mnist_setup):
    svc = _prod_svc(mnist_setup)                       # K = 4
    m = svc._advance(12)
    flushed = m["flushed"].reshape(3, 4)
    assert not flushed[:, :-1].any() and flushed[:, -1].all()
    assert int(svc.state.version) == 3 and int(svc.state.buf_count) == 0
    assert not svc.state.buf.any() and not svc.state.taken.any()
    assert int(svc.state.g_opt_state.step) == 3
    v1 = _prod_svc(mnist_setup, buffer_k=2, version_window=1)
    assert max(v1.run_async(4, eval_every=4).staleness) == 0


@pytest.mark.parametrize("layout", ["dense", "hierarchical"])
def test_dispatch_solicitation_disjoint_and_billed(mnist_setup, layout):
    svc = _prod_svc(mnist_setup, solicit="dispatch", layout=layout)
    sol = svc.state.solicited.numpy()
    inflight = svc.state.inflight.numpy()
    cl = svc.state.age.cluster_of.numpy()
    for c in np.unique(cl):
        coords = sol[cl == c].ravel()
        assert len(set(coords.tolist())) == (cl == c).sum() * svc.hp.r
        assert set(np.flatnonzero(inflight[c])) == set(coords.tolist())
    # the recluster at 3 re-keys the in-flight marks: exactly the
    # solicitations, at the new cluster rows
    res = svc.run_async(3, eval_every=3)
    sol = svc.state.solicited.numpy()
    assert all(len(set(row.tolist())) == svc.hp.r for row in sol)
    cl = svc.state.age.cluster_of.numpy()
    assert len(set(cl.tolist())) < N
    assert svc.state.inflight.shape[0] == (
        cl.max() + 1 if layout == "hierarchical" else N)
    want = np.zeros(svc.state.inflight.shape, bool)
    for i in range(N):
        want[cl[i], sol[i]] = True
    np.testing.assert_array_equal(svc.state.inflight.numpy(), want)
    events = len(res.clients) + len(svc.run_async(1, eval_every=1).clients)
    d, hp = svc.d, svc.hp
    assert svc.cum_uplink == events * bytes_per_round(
        hp.k, d, wire_dtype=hp.wire_dtype)
    assert svc.cum_downlink == (N + events) * hp.r * bytes_per_index(d)


def test_constructor_validation(mnist_setup, monkeypatch):
    shards, test = mnist_setup

    def mk(hp, **kw):
        return AsyncService("mlp", shards, test, hp, device="cpu", **kw)
    with pytest.raises(ValueError, match="rAge-k"):
        mk(RAgeKConfig(method="top_k", **HP))
    with pytest.raises(ValueError, match="solicit"):
        mk(_hp(), solicit="queue")
    with pytest.raises(ValueError):
        mk(_hp(k=40))
    with pytest.raises(ValueError, match="version_window"):
        mk(_hp(version_window=0))
    with pytest.raises(ValueError, match="buffer_k"):
        mk(_hp(buffer_k=N + 1))
    with pytest.raises(ValueError, match="staleness_eta"):
        mk(_hp(staleness_eta=-0.5))
    with pytest.raises(ValueError, match="latency model"):
        mk(_hp(), latency=LatencyModel(N + 3, device="cpu"))
    with pytest.raises(ValueError, match="FaultModel"):
        mk(_hp(), faults=FaultModel(3, device="cpu"))
    with pytest.raises(ValueError, match="backoff"):
        mk(_hp(), backoff=0.5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: AsyncService("mlp", shards, test, _hp()),
                 lambda: LatencyModel(N), lambda: FaultModel(N)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_draw_one_advances_only_its_row(mnist_setup):
    """draw_one(i) is draw's row i and leaves every other row as it was;
    a client's batches follow its own count, whoever else drew."""
    shards, _ = mnist_setup
    store = DeviceShardStore(shards, 16, seed=17, device="cpu")
    st0 = store.init_state()
    i = torch.tensor(4)
    full, one, mixed = st0, st0, st0
    for step in range(12):             # past an epoch wrap of every shard
        bx_all, by_all, full = store.draw(store.data, full, 3)
        bx, by, new = store.draw_one(store.data, one, 3, i)
        assert torch.equal(bx, bx_all[4]) and torch.equal(by, by_all[4])
        for a, b, old in zip(new, full, one):
            assert torch.equal(a[4], b[4])
            assert torch.equal(torch.cat([a[:4], a[5:]]),
                               torch.cat([old[:4], old[5:]]))
        one = new
        # another client draws in between: client 4's batches hold
        _, _, mixed = store.draw_one(store.data, mixed, 2,
                                     torch.tensor(step % 3))
        mx, my, mixed = store.draw_one(store.data, mixed, 3, i)
        assert torch.equal(my, by_all[4]) and torch.equal(mx, bx_all[4])
    assert int(full.epoch[4]) >= 2


def test_faults_counters_backoff_and_dark(mnist_setup):
    flt = FaultModel(N, p_nan=0.2, p_crash=0.1, p_drop=0.2, dark=(3,),
                     seed=9, device="cpu")
    svc = _prod_svc(mnist_setup, faults=flt)
    res = svc.run_async(6, eval_every=3)
    s = res.summary()
    assert s["aggregations"] == 6
    assert s["total_crashed"] > 0 and s["total_quarantined"] > 0
    assert s["total_dropped"] > 0
    assert s["total_retried"] == (s["total_crashed"] + s["total_dropped"]
                                  + s["total_quarantined"])
    ev = np.asarray(res.clients)
    crashed = np.asarray(res.crashed)
    assert crashed[ev == 3].all() and (ev == 3).any()
    # the dark client never lands: it requests nothing, and each failed
    # dispatch backs its next one off by backoff^retries
    assert not svc.freq_matrix[3].any()
    retries = min(int((ev == 3).sum()), svc._max_retries)
    assert int(svc.state.n_retry[3]) == retries
    last = np.asarray(res.event_clock, np.float32)[ev == 3][-1]
    lat = svc._latency.dispatch_s(0, torch.tensor([3]),
                                  svc.state.n_dispatch[3:4])
    assert float(svc.state.next_done[3]) == float(
        torch.tensor(last) + lat * 2.0 ** retries)
    assert np.isfinite(res.loss).all()
    assert torch.isfinite(svc.state.g_params).all()
    # the uplink bills every landing but the crashed ones
    assert res.uplink_bytes[-1] == svc._uplink_per_landing * int(
        (~crashed).sum())


def test_stall_raises(mnist_setup, monkeypatch):
    monkeypatch.setattr(TSvc, "STALL_CHUNKS", 3)
    svc = _prod_svc(mnist_setup, buffer_k=2,
                    faults=FaultModel(N, p_crash=1.0, device="cpu"))
    with pytest.raises(RuntimeError, match="stalled"):
        svc.run_async(1)
    assert svc.events_done == 6


@pytest.mark.parametrize("layout,solicit", [("dense", "report"),
                                            ("hierarchical", "dispatch")])
def test_resume_bitwise(mnist_setup, tmp_path, layout, solicit):
    flt = FaultModel(N, p_nan=0.2, p_crash=0.1, seed=9, device="cpu")
    kw = dict(layout=layout, solicit=solicit, faults=flt)
    ref = _prod_svc(mnist_setup, **kw)
    r_ref = ref.run_async(6, eval_every=2)
    a = _prod_svc(mnist_setup, **kw)
    with AsyncCheckpointer(str(tmp_path)) as ck:
        a.run_async(4, eval_every=2, checkpointer=ck, ckpt_every=4)
    b = _prod_svc(mnist_setup, **kw)
    b.load_state(str(tmp_path))
    assert b.aggs_done == 4
    res = b.run_async(2, eval_every=2)
    assert res.acc == r_ref.acc[-1:] and res.loss == r_ref.loss[-1:]
    assert res.clients == r_ref.clients[-len(res.clients):]
    _same_state(ref, b)
    np.testing.assert_array_equal(ref.freq_matrix, b.freq_matrix)
