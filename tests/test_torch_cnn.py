"""The port's CIFAR CNN slice (Network-2, d = 2,515,338) against the JAX
package: data, model, one engine round, and the recluster.

Inputs are the reference's settings for the CNN engine
(``tests/test_engine_golden.py``): ``cifar10_like(n_train=600,
n_test=240)`` in ``paper_cifar_split`` (6 clients), r 200, k 20, H 1,
batch 8. Both packages start from the reference's ``cnn_init`` parameters
and BatchNorm state, carried across by ``weights.params_from_jax``.
The test marked ``cuda`` needs no JAX and runs on a machine with a card;
the others skip where JAX, the reference, is missing. Tolerances, each
with its reason:
- the model: logits and BatchNorm state within rtol=atol=1e-5 (the same
  float32 operations, convolutions and batch statistics summed in
  another order); the flat gradient within rtol=1e-4, atol=1e-6 (a
  backward through four BatchNorms and the 2048-wide flatten);
- one engine round of rAge-k (segmented and scan), rTop-k, CAFe, top-k
  and dense: losses, the aggregated gradient, the new global params and
  the BatchNorm state within rtol=1e-4, atol=1e-6; requested indices,
  cluster ages and request counts exactly. The reference's own
  last-step gradients also go through the port's report and selection,
  which must give the reference's integers exactly.
"""
import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)
import torch.nn.functional as F

try:
    import jax
    import jax.numpy as jnp
    from repro.core import strategies as JS
    from repro.data import federated as JFed
    from repro.data import synthetic as JSyn
    from repro.fl import client as JC
    from repro.models import paper_nets as JP
    from test_torch_engine import _one_round, _sparse_sum
    from test_torch_participation import partial_rounds
except ImportError:
    jax = None

from repro_torch.configs.base import RAgeKConfig
from repro_torch.core import strategies as TS
from repro_torch.data import federated as TFed
from repro_torch.data import synthetic as TSyn
from repro_torch.device import strict_fp32
from repro_torch.fl import client as TC
from repro_torch.fl.engine import FederatedEngine
from repro_torch.models import paper_nets as TP
from repro_torch.weights import params_from_jax

CIFAR = dict(r=200, k=20, H=1, M=2, lr=1e-3, batch_size=8)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ROUND_TOL = dict(rtol=1e-4, atol=1e-6)
D = 2_515_338


@pytest.fixture(scope="module")
def cifar_data():
    (x, y), test = TSyn.cifar10_like(n_train=600, n_test=240, seed=0)
    return TFed.paper_cifar_split(x, y, seed=0), test


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("needs JAX, the reference")


@pytest.fixture(scope="module")
def jinit(jax_ref):
    """The reference's (params, state) at PRNGKey(0), as numpy trees."""
    return jax.tree_util.tree_map(np.asarray,
                                  JP.cnn_init(jax.random.PRNGKey(0)))


def _to_port(tree):
    return params_from_jax(tree, "cpu")


def _flat_np(tree):
    return np.asarray(JC.flatten_tree(tree))


def _paths(tree, prefix=()):
    """(path, shape) of every leaf in the port's flat order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        prefix + (k,))]
    return [(prefix, tuple(tree.shape))]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# ---------------------------------------------------------------------------
# model and data
# ---------------------------------------------------------------------------


def test_cnn_size_and_leaf_order(jinit):
    jparams, jstate = jinit
    tparams, tstate = TP.cnn_init(torch.Generator().manual_seed(0), "cpu")
    want = [(tuple(k.key for k in path), leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert _paths(tparams) == want
    assert [p[0][-1] for p in want[:4]] == ["b", "bn_bias", "bn_scale", "w"]
    assert [p[0][0] for p in want[-10::2]] == [f"fc{j}" for j in range(5)]
    assert TP.param_count(tparams) == JP.param_count(jparams) == D
    assert _paths(tstate) == [
        (tuple(k.key for k in path), leaf.shape) for path, leaf in
        jax.tree_util.tree_flatten_with_path(jstate)[0]]
    flat = TC.flatten_tree(_to_port(jparams))
    np.testing.assert_array_equal(flat.numpy(), _flat_np(jparams))
    back = TC.unflattener(tparams)(flat)
    for a, b in zip(TC.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(TC.tree_leaves(tstate),
                    jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_cifar10_like_and_paper_split_match(jax_ref):
    (jx, jy), (jxt, jyt) = JSyn.cifar10_like(n_train=300, n_test=60, seed=3)
    (tx, ty), (txt, tyt) = TSyn.cifar10_like(n_train=300, n_test=60, seed=3)
    for a, b in ((jx, tx), (jy, ty), (jxt, txt), (jyt, tyt)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tx.shape == (300, 32, 32, 3)
    assert TFed.PAPER_CIFAR_LABELS == JFed.PAPER_CIFAR_LABELS
    js = JFed.paper_cifar_split(jx, jy, seed=5)
    ts = TFed.paper_cifar_split(tx, ty, seed=5)
    assert len(ts) == 6
    for (ja, jb), (ta, tb), labels in zip(js, ts, TFed.PAPER_CIFAR_LABELS):
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(jb, tb)
        assert set(tb.tolist()) <= set(labels)


def test_params_from_jax_carries_params_and_state_exactly(jinit):
    """Both trees arrive with the same nesting, shapes, dtypes and bits."""
    for jtree in jinit:
        ttree = _to_port(jtree)
        assert _paths(ttree) == [(tuple(k.key for k in p), l.shape) for p, l
                                 in jax.tree_util.tree_flatten_with_path(
                                     jtree)[0]]
        for a, b in zip(TC.tree_leaves(ttree),
                        jax.tree_util.tree_leaves(jtree)):
            assert a.dtype == torch.float32 and b.dtype == np.float32
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          b.view(np.int32))


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _trained_state(jparams, jstate, x):
    """A BatchNorm state off its initial (0, 1): one training apply's."""
    return jax.tree_util.tree_map(
        np.asarray, JP.cnn_apply(jparams, jstate, jnp.asarray(x), True)[1])


@pytest.mark.parametrize("train", [True, False])
def test_cnn_apply_matches(jinit, train):
    """Logits and the new BatchNorm state against the reference, in
    training (batch statistics, the running update) and in eval (the
    running statistics, here ones a training step moved)."""
    jparams, jstate = jinit
    x, _ = _batch(8)
    if not train:
        jstate = _trained_state(jparams, jstate, _batch(8, seed=1)[0])
    want, want_s = JP.cnn_apply(jparams, jstate, jnp.asarray(x), train=train)
    got, got_s = TP.cnn_apply(_to_port(jparams), _to_port(jstate),
                              torch.from_numpy(x), train=train)
    assert got.shape == (8, 10)
    _close(got, want, MODEL_TOL)
    for i in range(4):
        for s in ("mean", "var"):
            _close(got_s[f"conv{i}"][s], want_s[f"conv{i}"][s], MODEL_TOL)


def test_cnn_flat_gradient_matches_jax_grad(jinit):
    jparams, jstate = jinit
    x, y = _batch(8, seed=2)

    def jloss(p):
        logits, _ = JP.cnn_apply(p, jstate, jnp.asarray(x), train=True)
        return JC.softmax_xent(logits, jnp.asarray(y))

    want = _flat_np(jax.grad(jloss)(jparams))
    tparams = _to_port(jparams)
    flat = TC.flatten_tree(tparams).requires_grad_(True)
    logits, _ = TP.cnn_apply(TC.unflattener(tparams)(flat),
                             _to_port(jstate), torch.from_numpy(x))
    (got,) = torch.autograd.grad(
        TC.softmax_xent(logits, torch.from_numpy(y).long()), flat)
    assert got.shape == (D,)
    _close(got, want, GRAD_TOL)


def test_stacked_apply_equals_per_client_loop(jinit):
    """Three clients with their own params and BatchNorm state in one
    grouped-convolution apply, against one apply per client."""
    jparams, jstate = jinit
    n = 3
    trees = [_to_port(jax.tree_util.tree_map(np.asarray,
                                             JP.cnn_init(jax.random.PRNGKey(i))
                                             [0])) for i in range(n)]
    states = [_to_port(_trained_state(jparams, jstate, _batch(4, i)[0]))
              for i in range(n)]
    x = torch.from_numpy(np.stack([_batch(6, seed=10 + i)[0]
                                   for i in range(n)]))
    stacked = TC.unflattener(trees[0])(
        torch.stack([TC.flatten_tree(t) for t in trees]))
    for train in (True, False):
        got, got_s = TP.cnn_apply(stacked, TC.stack_clients(states), x,
                                  train=train)
        assert got.shape == (n, 6, 10)
        for i in range(n):
            want, want_s = TP.cnn_apply(trees[i], states[i], x[i],
                                        train=train)
            _close(got[i], want, MODEL_TOL)
            for a, b in zip(TC.tree_leaves(TC.client_tree(got_s, i)),
                            TC.tree_leaves(want_s)):
                _close(a, b, MODEL_TOL)


@pytest.mark.parametrize("size,stride", [(8, 2), (8, 1), (7, 2), (5, 1)])
def test_same_padding_matches_lax(jax_ref, size, stride):
    """XLA's SAME padding: symmetric at stride 1, (0, 1) at stride 2 on
    an even size, where ``F.conv2d(padding=1)`` keeps the shape and
    reads the wrong pixels."""
    rng = np.random.default_rng(size + stride)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    got = TP.conv2d_same(xt, wt, None, stride, groups=1).permute(0, 2, 3, 1)
    _close(got, want, MODEL_TOL)
    before, after = TP.same_pad(size, stride)
    assert (before, after) == ((0, 1) if (size, stride) == (8, 2)
                               else (1, 1))
    if before != after:
        naive = F.conv2d(xt, wt, stride=stride, padding=1).permute(0, 2, 3, 1)
        assert naive.shape == want.shape
        assert np.abs(naive.numpy() - want).max() > 1.0


def test_batchnorm_running_stats_use_population_variance(jax_ref):
    """The running update is 0.9 old + 0.1 batch of the ddof-0 variance,
    as the reference's ``_bn``; ``F.batch_norm`` would use the unbiased
    one."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 3, 3, 5)) * 2 + 1).astype(np.float32)
    p = {"bn_scale": rng.standard_normal(5).astype(np.float32),
         "bn_bias": rng.standard_normal(5).astype(np.float32)}
    s = {"mean": rng.standard_normal(5).astype(np.float32),
         "var": rng.uniform(0.5, 2, 5).astype(np.float32)}
    for train in (True, False):
        want, want_s = JP._bn(jnp.asarray(x), p, s, train)
        ts = {k: torch.from_numpy(v).view(1, 5) for k, v in s.items()}
        got, got_s = TP._bn(torch.from_numpy(x).permute(0, 3, 1, 2),
                            {k: torch.from_numpy(v) for k, v in p.items()},
                            ts, train)
        _close(got.permute(0, 2, 3, 1), want, MODEL_TOL)
        for k in ("mean", "var"):
            _close(got_s[k][0], want_s[k], MODEL_TOL)
    rv = torch.from_numpy(s["var"]).clone()
    F.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 torch.from_numpy(s["mean"]).clone(), rv, training=True,
                 momentum=0.1)
    assert np.abs(rv.numpy() - np.asarray(want_s["var"])).max() > 1e-2


def test_local_phase_threads_batchnorm_state_in_fp32(cifar_data,
                                                     monkeypatch):
    """The engine's CNN convolutions run with TF32 off, whatever the
    caller set, and the caller's settings come back; the BatchNorm state
    comes out of the phase moved."""
    seen = []
    conv = F.conv2d

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return conv(*a, **kw)

    monkeypatch.setattr(F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    shards, test = cifar_data
    eng = FederatedEngine("cnn", shards, test, RAgeKConfig(**CIFAR),
                          seed=0, device="cpu")
    eng.step()
    n_train = len(seen)
    eng.eval_acc()
    assert n_train == 4 and len(seen) == 4 + 4 * eng.n
    assert set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    assert eng.state_s["conv0"]["var"].shape == (6, 64)
    assert not torch.equal(eng.state_s["conv0"]["mean"],
                           torch.zeros(6, 64))


# ---------------------------------------------------------------------------
# one engine round against the reference's masked path
# ---------------------------------------------------------------------------


def _assert_round_matches(jeng, jm, jG, teng, tm, params0=None):
    """Losses, G, the aggregate (dense: the sum of the whole gradients)
    and the BatchNorm state within tolerance; ages and counts exactly. Without ``params0`` the requested indices
    exactly and the new global params within tolerance; with it (the
    initial flat params, where the picks are drawn) the global step
    moved exactly the coordinates that the port's aggregate holds."""
    _close(tm["losses"], jm["losses"], ROUND_TOL)
    _close(tm["G"], jG, ROUND_TOL)
    if tm["idx"] is None:                 # dense: the whole gradients
        assert jm["idx"] is None
        _close(tm["g_sum"], jG.sum(0), ROUND_TOL)
    else:
        _close(tm["g_sum"], _sparse_sum(jG, tm["idx"].numpy()), ROUND_TOL)
    if params0 is None:
        got, want = teng.g_params.numpy(), _flat_np(jeng.g_params)
        keep = np.ones(got.shape, bool)
        if tm["idx"] is not None:
            np.testing.assert_array_equal(tm["idx"].numpy(), jm["idx"])
        else:
            # dense: Adam's first step moves each coordinate by up to lr
            # in the direction of its gradient, which where the gradient
            # lies within atol of zero (the conv biases, whose gradient
            # BatchNorm cancels) is the sign of float noise in either
            # package; there the two steps can only differ by 2 lr
            keep = np.abs(jG.sum(0)) > ROUND_TOL["atol"]
            assert np.abs(got - want)[~keep].max() <= 2 * CIFAR["lr"]
        _close(got[keep], want[keep], ROUND_TOL)
    else:
        np.testing.assert_array_equal(
            np.nonzero(teng.g_params.numpy() != params0)[0],
            np.nonzero(tm["g_sum"].numpy())[0])
    for a, b in zip(TC.tree_leaves(teng.state_s),
                    jax.tree_util.tree_leaves(jeng.state_s)):
        assert tuple(a.shape) == b.shape
        _close(a, b, ROUND_TOL)
    np.testing.assert_array_equal(teng.age.cluster_age.numpy(),
                                  np.asarray(jeng.age.cluster_age))
    np.testing.assert_array_equal(teng.age.freq.numpy(),
                                  np.asarray(jeng.age.freq))


@pytest.fixture(scope="module")
def rage_round(jax_ref, cifar_data):
    """The reference's rAge-k CNN round 1 (segmented, masked) and the
    port's, once for the module: the segmented case checks it and
    ``reference_G`` takes its gradients, which the reference's engine of
    the same config draws alike."""
    shards, test = cifar_data
    return _one_round(shards, test, CIFAR, kind="cnn")


@pytest.mark.parametrize("selection", ["segmented", "scan"])
def test_cnn_round_matches_reference_rage_k(jax_ref, cifar_data, selection,
                                            request):
    shards, test = cifar_data
    if selection == "segmented":
        jeng, jm, jG, teng, tm = request.getfixturevalue("rage_round")
    else:
        jeng, jm, jG, teng, tm = _one_round(shards, test, CIFAR,
                                            kind="cnn", selection=selection)
    assert teng.d == D and tm["idx"].shape == (6, CIFAR["k"])
    _assert_round_matches(jeng, jm, jG, teng, tm)


def test_cnn_round_matches_reference_rtop_k(jinit, cifar_data):
    """rTop-k draws from each package's own generator: the candidate
    reports equal, every pick inside its report, the rest as for rAge-k
    but the new params, which differ where the draws do."""
    shards, test = cifar_data
    hp = {**CIFAR, "method": "rtop_k"}
    jeng, jm, jG, teng, tm = _one_round(shards, test, hp, kind="cnn")
    _assert_round_matches(jeng, jm, jG, teng, tm,
                          params0=_flat_np(jinit[0]))
    want = np.asarray(JS.client_candidates(jnp.asarray(jG), CIFAR["r"],
                                           "threshold"))
    got = TS.client_candidates(tm["G"], CIFAR["r"], "threshold").numpy()
    np.testing.assert_array_equal(got, want)
    for picks, jpicks, cand in zip(tm["idx"].numpy(), jm["idx"], want):
        assert len(set(picks.tolist())) == CIFAR["k"]
        assert set(picks.tolist()) <= set(cand.tolist())
        assert set(jpicks.tolist()) <= set(cand.tolist())


@pytest.mark.parametrize("method", ["cafe", "top_k", "dense"])
def test_cnn_round_matches_reference_methods(jax_ref, cifar_data, method):
    """The deterministic baselines on the CNN, as for rAge-k; dense
    requests nothing and sums the whole gradients."""
    shards, test = cifar_data
    jeng, jm, jG, teng, tm = _one_round(shards, test,
                                        {**CIFAR, "method": method},
                                        kind="cnn")
    assert (tm["idx"] is None) == (method == "dense")
    _assert_round_matches(jeng, jm, jG, teng, tm)


def test_cnn_gathered_round_matches_reference_masked(jax_ref, cifar_data):
    """The port's gathered CNN round (grouped convolutions over the m = 2
    active clients, their BatchNorm rows gathered and put back) against
    the reference's masked round under the same plan, restricted to the
    active rows: the reference's own gathered CNN round is not its
    masked one (ROADMAP section 3, fault 5). Picks, ages and counts
    exactly; losses (NaN outside the round), the new params and the
    BatchNorm state (held outside the round) within the round's
    tolerance."""
    shards, test = cifar_data
    _, teng, tm = partial_rounds(
        "cnn", shards, test, CIFAR, active=[0, 1, 0, 0, 1, 0], m=2,
        compute="masked", port_compute="gathered", tol=ROUND_TOL)
    assert teng._compute == "gathered" and tm["G"].shape == (2, D)


def test_cnn_random_k_round(cifar_data):
    """random-k draws from torch's generator: k distinct real indices a
    client, their uploads summed."""
    shards, test = cifar_data
    eng = FederatedEngine("cnn", shards, test,
                          RAgeKConfig(**CIFAR, method="random_k"), seed=0,
                          device="cpu")
    m = eng.step()
    idx = m["idx"]
    assert idx.shape == (6, CIFAR["k"]) and np.isfinite(m["losses"]).all()
    assert ((idx >= 0) & (idx < D)).all()
    assert all(len(set(row)) == CIFAR["k"] for row in idx.tolist())


@pytest.fixture(scope="module")
def reference_G(rage_round):
    """The reference's last-step gradients of its round 1 (6, d)."""
    return np.array(rage_round[2])


@pytest.mark.parametrize("cluster_of", [[0, 1, 2, 3, 4, 5],
                                        [0, 0, 1, 1, 2, 2],
                                        [0, 0, 0, 0, 0, 0]])
def test_reference_gradients_pin_report_and_selection(reference_G,
                                                      cluster_of):
    """The reference's own CNN gradients through the port's report and
    segmented selection: the integers equal the reference's exactly,
    whatever the two packages' float gradients do. Clusters before a
    recluster (6 x 1), the label groups (3 x 2) and all six in one (1 x
    6); the ages come from a seeded draw so that the picks leave the
    report's first k."""
    G = reference_G
    r, k = CIFAR["r"], CIFAR["k"]
    rng = np.random.default_rng(7)
    cluster_age = rng.integers(0, 3, G.shape).astype(np.int32)
    cl = np.asarray(cluster_of, np.int32)
    bounds = dict(num_segments=int(cl.max()) + 1,
                  max_seg=int(np.bincount(cl).max()))
    want_rep = np.asarray(JS.client_candidates(jnp.asarray(G), r,
                                               "threshold"))
    got_rep = TS.client_candidates(torch.from_numpy(G), r, "threshold")
    np.testing.assert_array_equal(got_rep.numpy(), want_rep)
    j_idx, j_age, _ = JS.segmented_rage_select(
        jnp.asarray(G), jnp.asarray(cluster_age), jnp.asarray(cl), r=r, k=k,
        candidates="threshold", **bounds)
    t_idx, t_age, _ = TS.segmented_rage_select(
        None, torch.from_numpy(cluster_age), torch.from_numpy(cl), r=r,
        k=k, cands=got_rep, d=G.shape[1], **bounds)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_age.numpy(), np.asarray(j_age))
    if len(set(cluster_of)) < len(cluster_of):
        for c in set(cluster_of):
            rows = [set(t_idx[i].tolist()) for i in np.where(cl == c)[0]]
            assert sum(map(len, rows)) == len(set().union(*rows))


# ---------------------------------------------------------------------------
# the recluster, and what kind="cnn" builds
# ---------------------------------------------------------------------------


def test_cnn_engine_reclusters_and_selection_planes_agree(cifar_data):
    """Four rounds with M 2 and a DBSCAN eps that joins every client: the
    round-2 recluster puts all six in one cluster, so rounds 3-4 select
    on the (1, 6) layout. The segmented plane equals the sequential scan
    round for round, and every member of the cluster picks disjointly."""
    shards, test = cifar_data
    hp = RAgeKConfig(**{**CIFAR, "eps": 1.0})
    runs = {}
    for selection in ("segmented", "scan"):
        eng = FederatedEngine("cnn", shards, test, hp, seed=1,
                              device="cpu", selection=selection)
        res = eng.run(4, eval_every=2)
        runs[selection] = (eng, res)
    eng, res = runs["segmented"]
    assert eng.round_idx == 4 and eng.recluster_s > 0
    assert eng.cluster_of.tolist() == [0] * 6
    assert (eng._num_seg, eng._max_seg) == (1, 6)
    assert res.cluster_labels[0].tolist() == [0] * 6
    assert np.isfinite(res.loss).all() and 0.0 <= res.acc[-1] <= 1.0
    # k float32 values and 3-byte indices (d < 2^24), and the r-report
    assert res.uplink_bytes[-1] == 4 * 6 * (20 * (4 + 3) + 200 * 3)
    for a, b in zip(res.requested, runs["scan"][1].requested):
        np.testing.assert_array_equal(a, b)
    for idx in res.requested[2:]:
        assert len(set(idx.reshape(-1).tolist())) == 6 * CIFAR["k"]
    np.testing.assert_array_equal(eng.age.cluster_age.numpy(),
                                  runs["scan"][0].age.cluster_age.numpy())
    np.testing.assert_array_equal(eng.freq_matrix,
                                  runs["scan"][0].freq_matrix)


def test_cnn_kind_builds_with_reference_state_shapes(cifar_data):
    shards, test = cifar_data
    eng = FederatedEngine("cnn", shards, test, RAgeKConfig(**CIFAR),
                          seed=0, device="cpu")
    assert eng.d == D and eng.params_s.shape == (6, D)
    assert {k: {s: tuple(v.shape) for s, v in d.items()}
            for k, d in eng.state_s.items()} == {
        f"conv{i}": {"mean": (6, c), "var": (6, c)}
        for i, c in enumerate((64, 128, 256, 512))}
    assert eng._store.data[0].shape[2:] == (32, 32, 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_cnn_convolutions_run_in_fp32(cuda, cifar_data, monkeypatch):
    """On the card, with TF32 switched on globally, the engine's CNN
    still computes in float32: its round-1 losses and gradients agree
    with the CPU's at the float32 tolerance (TF32 would miss it by
    orders of magnitude), and the global switch comes back on."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    shards, test = cifar_data
    hp = RAgeKConfig(**CIFAR)
    card, cpu = (FederatedEngine("cnn", shards, test, hp, seed=0,
                                 device=where) for where in (cuda, "cpu"))
    bx, by, _ = cpu._store.draw(cpu._data, cpu.samp, hp.H)
    mh = cpu._round_impl(bx, by)
    mc = card._round_impl(bx.to(cuda), by.to(cuda))
    _close(mc["losses"].cpu(), mh["losses"], ROUND_TOL)
    _close(mc["G"].cpu(), mh["G"], ROUND_TOL)
    assert torch.backends.cudnn.allow_tf32
    with strict_fp32():
        assert not torch.backends.cudnn.allow_tf32
