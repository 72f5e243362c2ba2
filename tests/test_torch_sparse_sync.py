"""The port's sparse gradient sync (``repro_torch.dist.sparse_sync``,
``launch.mesh.make_host_mesh``) against the JAX package's, on the CPU.

The gradients are the reference's own: the float32 loss gradient of
internlm2-1.8b's smoke config (11 leaves, 361,088 coordinates) on a
seeded batch, handed to both packages. Given the same gradients, the
syncs agree exactly: selected indices (the synced values' support),
synced values, ages, cost lanes and every stat. Three whole training
steps from the same parameters agree within 1e-5 on the losses and
1e-4 on the parameters (Adam's steps of lr 1e-3 turn a gradient's last
bits into a few 1e-5 of step where the gradient is near 0), ages
exactly.

- ``sync_grads`` (the single program's gradient to wire) against the
  reference's jitted ``make_sync_train_step``, read through a linear
  loss whose gradient is the handed one and SGD at lr 1 from zeros, so
  the new parameters are minus the synced gradient exactly.
- ``make_manual_sync`` and ``make_buffered_sync`` at world size 1
  against the reference on ``make_host_mesh(1, 1)``.
- Two gloo ranks (``tests/sync_ranks.py``, spawned once for the
  module): identical gradients on both ranks against the reference's
  manual sync on a 2-device CPU mesh (a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=2``), and distinct
  gradients against a numpy oracle of the union semantics.
- Three and four gloo ranks (one spawn a world size), every scenario,
  distinct gradients too (from rank 2 on rank 0's scaled, so three or
  more uploads land on one coordinate), against the reference on as many
  forced devices, each device's buffer its rank's gradient: ages and
  stats exactly; synced values bitwise where the reference's arithmetic
  is the port's (its scatter sums in rank order, as ``sparse_aggregate``
  does), else within ``sync_ranks.RANKS_RTOL`` (``sync_ranks.exact_at``:
  its static 1/3 and its dense all-reduce's own order).
"""
import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

try:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke_config as j_smoke_config
    from repro.core.sparsify import bucket_budgets as j_bucket_budgets
    from repro.dist import sparse_sync as JS
    from repro.launch.mesh import make_host_mesh as j_mesh
    from repro.models import transformer as JT
    from repro.optim import optimizers as JO
except ImportError:         # the card's machine: the card's cases alone
    jax = None

from repro_torch import tree
from repro_torch.configs import get_smoke_config
from repro_torch.dist import sharding as SH
from repro_torch.dist import sparse_sync as TS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizers as TO
from repro_torch.weights import ages_from_jax, params_from_jax

import sync_ranks

ARCH = "internlm2-1.8b"
R, K = 512, 64


def _np(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x)


def _carry(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _batch(seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (b, s)).astype(np.int32)
    labels = rng.integers(0, 512, (b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """The reference's smoke-config parameters and their float32 loss
    gradient on a seeded batch, once for the module. The two-rank runs of
    ``tests/sync_ranks.py`` start here on these gradients, in the
    background, and ``two_ranks`` collects them."""
    if jax is None:
        pytest.skip("needs JAX, the reference")
    cfg = j_smoke_config(ARCH).replace(dtype="float32", remat=False)
    params = JT.init(cfg, jax.random.PRNGKey(0))
    jb, _ = _batch()
    grads = jax.jit(jax.grad(lambda p, b: JT.loss_fn(p, cfg, b)[0]))(
        params, jb)
    d = tmp_path_factory.mktemp("ranks")
    procs = sync_ranks.start(
        [np.asarray(l) for l in jax.tree_util.tree_leaves(grads)], d, R, K,
        worlds=(2, 3, 4))
    yield dict(cfg=cfg, params=params, grads=grads, ranks=(d, procs))
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.communicate()


def _small(grads):
    """Three buckets of the gradients (the embedding, one MLP matrix, the
    final norm's scale): the manual syncs' cases compile the reference's
    exchange a bucket at a time, and three keep that short."""
    return {"embed": grads["embed"],
            "layers": {"mlp": {"w1": grads["layers"]["mlp"]["w1"]}},
            "norm_f": grads["norm_f"]}


_JIT = {}


def _jmanual(grads, buffer_k=0, **kw):
    """The reference's manual (or buffered) sync on ``make_host_mesh(1,
    1)`` for ``grads``' shapes, jitted once per setting for the module."""
    key = (buffer_k, tuple(sorted(kw.items())))
    if key not in _JIT:
        specs = jax.tree_util.tree_map(lambda _: P(), grads)
        shapes = jax.tree_util.tree_map(
            lambda g: jax.ShapeDtypeStruct(g.shape, g.dtype), grads)
        base = (JS.make_buffered_sync(j_mesh(1, 1), specs, shapes,
                                      buffer_k=buffer_k, **kw) if buffer_k
                else JS.make_manual_sync(j_mesh(1, 1), specs, shapes, **kw))
        _JIT[key] = (base, jax.jit(base), shapes)
    return _JIT[key]


def _same(got, want):
    """Port tree (or tensor) == reference tree (or array), exactly."""
    g = tree.leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(_np(a), np.asarray(b).astype(
            _np(a).dtype))


# ---------------------------------------------------------------------------
# one program: sync_grads against make_sync_train_step
# ---------------------------------------------------------------------------

def _reference_sync(**kw):
    """The reference's gradient-to-wire, read off its jitted step:
    sync(grads, ages) -> (synced, new ages, stats). The loss <p, G> has
    gradient G, and SGD at lr 1 from zero parameters leaves -synced."""
    def loss_fn(p, batch):
        return sum(jnp.sum(a * b) for a, b in zip(
            jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(batch)))
    opt = JO.sgd(1.0)
    step = jax.jit(JS.make_sync_train_step(loss_fn, opt, None, **kw))

    def sync(grads, ages):
        p0 = jax.tree_util.tree_map(jnp.zeros_like, grads)
        p1, _, new_ages, _, stats = step(p0, opt.init(p0), ages, grads)
        return jax.tree_util.tree_map(lambda x: -x, p1), new_ages, stats
    return sync


@pytest.mark.parametrize("method,cand,dtype,whole", [
    ("rage_k", "sort", "float32", False),
    ("rage_k", "threshold", "float32", True),
    ("rage_k", "threshold", "bfloat16", False),
    ("cafe", "sort", "float32", False),
    ("cafe", "threshold", "float32", False),
    ("top_k", "sort", "float32", False), ("dense", "sort", "float32", False),
    ("dense", "sort", "bfloat16", False)])
def test_sync_grads_matches_reference(lm, method, cand, dtype, whole):
    """Three calls from fresh ages on the same gradients (the ages steer
    the picks away): synced values, ages and the per-shard bytes equal;
    on all 11 buckets, or on three (the reference compiles its step a
    bucket at a time)."""
    jg = jax.tree_util.tree_map(lambda g: g.astype(jnp.dtype(dtype)),
                                lm["grads"] if whole else _small(lm["grads"]))
    tg = _carry(jg)
    kw = dict(method=method, r=R, k=K, candidates=cand)
    jages = JS.init_age_state(jg, method=method)
    tages = TS.init_age_state(tg, method=method)
    ref = _reference_sync(**kw)
    for _ in range(3):
        jsyn, jages, jst = ref(jg, jages)
        tsyn, tages, tst = TS.sync_grads(tg, tages, **kw)
        _same(tsyn, jsyn)
        _same(tages, jages)
        assert tst["wire_bytes_per_shard"] == int(jst["wire_bytes_per_shard"])
        for a, b in zip(tree.leaves(tsyn), tree.leaves(tg)):
            assert a.dtype == b.dtype


def test_sync_grads_picks_the_budgets(lm):
    """k_b picks a bucket (the synced support), ``bucket_budgets`` in
    ``tree_leaves`` order; cafe's cost lane counts them."""
    tg = _carry(lm["grads"])
    sizes = [l.numel() for l in tree.leaves(tg)]
    budgets = j_bucket_budgets(sizes, R, K)
    ages = TS.init_age_state(tg, method="cafe")
    syn, ages, st = TS.sync_grads(tg, ages, method="cafe", r=R, k=K)
    for s, a, (_, k_b) in zip(tree.leaves(syn), tree.leaves(ages), budgets):
        assert int((s != 0).sum()) == k_b
        assert int(a[1].sum()) == k_b and int((a[0] == 0).sum()) == k_b
    assert st["wire_bytes_per_shard"] == sum(k for _, k in budgets) * 6


@pytest.mark.parametrize("method,cand", [("rage_k", "threshold"),
                                         ("dense", "sort")])
def test_three_steps_match_reference(lm, method, cand):
    """``make_sync_train_step`` on the smoke config's loss with Adam 1e-3,
    three steps from the reference's parameters and the same batches,
    against the reference's jitted step."""
    cfg = lm["cfg"]
    tcfg = get_smoke_config(ARCH).replace(dtype="float32", remat=False)
    kw = dict(method=method, r=R, k=K, candidates=cand)
    jopt, topt = JO.adam(1e-3), TO.adam(1e-3)
    jstep = jax.jit(JS.make_sync_train_step(
        lambda p, b: JT.loss_fn(p, cfg, b)[0], jopt, j_mesh(1, 1), **kw))
    tstep = TS.make_sync_train_step(
        lambda p, b: TT.loss_fn(p, tcfg, b)[0], topt,
        make_host_mesh(1, 1, device="cpu"), **kw)
    jp = lm["params"]
    js, ja = jopt.init(jp), JS.init_age_state(jp, method=method)
    tp = _carry(jp)
    ts, ta = topt.init(tp), TS.init_age_state(tp, method=method)
    for seed in (1, 2, 3):
        jb, tb = _batch(seed)
        jp, js, ja, jl, jst = jstep(jp, js, ja, jb)
        tp, ts, ta, tl, tst = tstep(tp, ts, ta, tb)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   atol=1e-5)
        _same(ta, ja)
        assert tst["wire_bytes_per_shard"] == int(jst["wire_bytes_per_shard"])
    for a, b in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)


def test_ages_carried_from_reference(lm):
    """A reference age tree after a step (cafe's stacked lanes) carried
    across: the port's next call equals the reference's."""
    jg = lm["grads"]
    kw = dict(method="cafe", r=R, k=K)
    ref = _reference_sync(**kw)
    _, ja, _ = ref(jg, JS.init_age_state(jg, method="cafe"))
    ta = ages_from_jax(jax.tree_util.tree_map(np.asarray, ja), "cpu")
    _same(ta, ja)
    jsyn, ja, _ = ref(jg, ja)
    tsyn, ta, _ = TS.sync_grads(_carry(jg), ta, **kw)
    _same(tsyn, jsyn)
    _same(ta, ja)
    with pytest.raises(ValueError, match="int32"):
        ages_from_jax({"a": np.zeros(3, np.float32)}, "cpu")


# ---------------------------------------------------------------------------
# the manual and buffered syncs at world size 1
# ---------------------------------------------------------------------------

def _tshapes(grads):
    return tree.tree_map(lambda g: torch.empty(g.shape, device="meta"),
                         _carry(grads))


def _stats_equal(tst, jst):
    assert set(tst) == set(jst)
    for k in jst:
        assert int(tst[k]) == int(jst[k]), k


@pytest.mark.parametrize("method,cand,validate", [
    ("rage_k", "sort", False), ("rage_k", "threshold", True),
    ("cafe", "sort", False), ("top_k", "sort", False),
    ("dense", "sort", False), ("dense", "sort", True)])
def test_manual_sync_matches_reference(lm, method, cand, validate):
    """Three calls: unmasked, the one shard active, the one shard
    inactive (sentinels: nothing lands, every age advances)."""
    jg = _small(lm["grads"])
    tshapes = _tshapes(jg)
    kw = dict(method=method, candidates=cand, r=R, k=K, validate=validate)
    jbase, jsync, shapes = _jmanual(jg, **kw)
    tsync = TS.make_manual_sync(make_host_mesh(1, 1, device="cpu"), None,
                                tshapes, **kw)
    assert tsync.n_data == jbase.n_data == 1
    tg = _carry(jg)
    ja = JS.init_age_state_sharded(shapes, method=method)
    ta = TS.init_age_state_sharded(tshapes, method=method, device="cpu")
    for act in (None, [True], [False]):
        jsyn, ja, jst = jsync(jg, ja, active=None if act is None
                              else jnp.asarray(act))
        tsyn, ta, tst = tsync(tg, ta, active=None if act is None
                              else torch.tensor(act))
        _same(tsyn, jsyn)
        _same(ta, ja)
        _stats_equal(tst, jst)
    assert not any(bool(l.any()) for l in tree.leaves(tsyn))


@pytest.mark.parametrize("bad", ["nan", "inf", "band"])
def test_manual_sync_gate_matches_reference(lm, bad):
    """The validation gate: a non-finite or out-of-band gradient is
    quarantined (nothing lands, ages advance with no reset) and still
    billed."""
    jg = _small(lm["grads"])
    leaf = jg["layers"]["mlp"]["w1"]
    val = {"nan": jnp.nan, "inf": jnp.inf, "band": 2e4}[bad]
    jbad = {**jg, "layers": {"mlp": {"w1": leaf.at[0, 0, 0].set(val)}}}
    tshapes = _tshapes(jg)
    kw = dict(method="rage_k", candidates="threshold", r=R, k=K,
              validate=True)
    _, jsync, shapes = _jmanual(jg, **kw)
    tsync = TS.make_manual_sync(make_host_mesh(1, 1, device="cpu"), None,
                                tshapes, **kw)
    ja = JS.init_age_state_sharded(shapes)
    ta = TS.init_age_state_sharded(tshapes, device="cpu")
    jsyn, ja, jst = jsync(jbad, ja)
    tsyn, ta, tst = tsync(_carry(jbad), ta)
    _same(tsyn, jsyn)
    _same(ta, ja)
    _stats_equal(tst, jst)
    assert int(tst["quarantined_shards"]) == 1
    assert int(tst["wire_bytes_total"]) == tst["wire_bytes_per_shard"]
    assert all(int(a.min()) == 1 for a in tree.leaves(ta))


def test_buffered_sync_matches_reference(lm):
    """buffer_k 3 at one shard: two buffering calls release zeros while
    the ages advance, the third flushes the mean of the three unions;
    buffer_k 1 is the base sync, call by call."""
    jg = _small(lm["grads"])
    tshapes = _tshapes(jg)
    kw = dict(method="rage_k", r=R, k=K)
    tmesh = make_host_mesh(1, 1, device="cpu")
    tg = _carry(jg)
    for bk in (3, 1):
        jbase, jsync, shapes = _jmanual(jg, buffer_k=bk, **kw)
        tsync = TS.make_buffered_sync(tmesh, None, tshapes, buffer_k=bk,
                                      **kw)
        jbuf, tbuf = jbase.init_buffer(), tsync.init_buffer()
        ja = JS.init_age_state_sharded(shapes)
        ta = TS.init_age_state_sharded(tshapes, device="cpu")
        for call in range(4):
            jsyn, ja, jbuf, jst = jsync(jg, ja, jbuf)
            tsyn, ta, tbuf, tst = tsync(tg, ta, tbuf)
            _same(tsyn, jsyn)
            _same(ta, ja)
            _same(tbuf.sums, jbuf.sums)
            assert int(tbuf.count) == int(jbuf.count)
            _stats_equal(tst, jst)
            assert bool(tst["flushed"]) == (bk == 1 or call == 2)


def test_manual_sync_rejections():
    mesh = make_host_mesh(1, 1, device="cpu")
    shapes = {"a": torch.empty((4,), device="meta")}
    with pytest.raises(ValueError, match="buffer_k"):
        TS.make_buffered_sync(mesh, None, shapes, buffer_k=0, r=2, k=1)
    # a (1, 2) spec: each of the leaf's two slices selects from its own
    # half with the split budget; a (1, 2) host mesh clamps to one process
    half = TS.make_manual_sync(SH.Mesh({"data": 1, "model": 2}),
                               {"a": SH.P("model")}, shapes, r=2, k=1)
    syn, _, st = half({"a": torch.tensor([1.0, -3.0])},
                      {"a": torch.zeros(2, dtype=torch.int32)})
    assert torch.equal(syn["a"], torch.tensor([0.0, -3.0]))
    assert st["wire_bytes_per_shard"] == 6
    assert make_host_mesh(1, 2, device="cpu").shape == {"data": 1,
                                                        "model": 1}
    with pytest.raises(ValueError, match="random_k"):
        TS.make_manual_sync(mesh, None, shapes, method="random_k", r=2, k=1)
    sync = TS.make_manual_sync(mesh, None, shapes, r=2, k=1)
    ages = TS.init_age_state_sharded(shapes, device="cpu")
    with pytest.raises(ValueError, match="active mask"):
        sync({"a": torch.ones(4)}, ages, active=torch.tensor([True, True]))
    assert TS.age_state_bytes(ages) == 16
    assert TS.age_state_bytes(TS.init_age_state_sharded(
        shapes, method="cafe", device="cpu")) == 32


def test_mesh_clamps_to_one_process(lm):
    """Without a process group the data axis clamps to 1, as the
    reference clamps to its device count; the card by default."""
    mesh = make_host_mesh(4, 1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None
    assert mesh.shape == dict(j_mesh(1, 1).shape)


def test_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh(1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.init_age_state_sharded({"a": torch.empty(3, device="meta")})


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(lm):
    """The scenarios of ``tests/sync_ranks.py`` on two gloo ranks and on
    the reference's 2-device CPU mesh (started by ``lm``)."""
    return sync_ranks.collect(*lm["ranks"])


def test_two_ranks_agree(two_ranks):
    """Both ranks hold the same synced values, ages and stats."""
    sync_ranks.check_ranks_agree(two_ranks)


def test_two_ranks_identical_grads_match_reference(two_ranks):
    """Identical gradients on both ranks against the reference's manual
    sync on a 2-device mesh (its grads replicated over the data axis),
    every scenario, both calls: synced values, ages, stats exactly."""
    sync_ranks.check_identical_match_reference(two_ranks)


def test_two_ranks_distinct_grads_match_oracle(two_ranks):
    """Distinct gradients (rank 1's are rank 0's reversed, x0.7; under the
    gate rank 1's second call is out of band): the union of both ranks'
    picks, divided by the active count, the hit-based ages and the
    stats, against the numpy oracle, exactly."""
    sync_ranks.check_distinct_match_oracle(two_ranks)


@pytest.fixture(scope="module", params=[3, 4])
def more_ranks(lm, request):
    """The scenarios on three or four gloo ranks and on the reference's
    mesh of as many devices (started by ``lm``)."""
    return request.param, sync_ranks.collect(*lm["ranks"], request.param)


def test_more_ranks_agree(more_ranks):
    sync_ranks.check_ranks_agree(more_ranks[1])


def test_more_ranks_match_reference(more_ranks):
    """Every scenario on n gloo ranks against the reference's manual sync
    on n devices; at four ranks every sparse call is bitwise."""
    n, runs = more_ranks
    exact = sync_ranks.check_ranks_match_reference(runs, n)
    calls = sum(len(s[4]) for s in sync_ranks.SCENARIOS)
    dense = sum(len(s[4]) for s in sync_ranks.SCENARIOS if s[1] == "dense")
    assert exact == (calls - dense if n == 4 else 8), exact


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the report's and sparse_aggregate's "
                    "kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["rage_k", "cafe"])
def test_card_syncs_equal_cpu(cuda, method):
    """The threshold plane's report kernels and the manual sync's
    ``sparse_aggregate`` on the card against their plain versions on the
    CPU, through both syncs on handed gradients (seeded, with ties):
    synced values, ages and stats exactly, two calls each."""
    gen = torch.Generator().manual_seed(0)
    grads = {"a": torch.randn((64, 300), generator=gen),
             "b": torch.round(torch.randn(5000, generator=gen) * 8) / 8}
    shapes = tree.tree_map(lambda g: g.to("meta"), grads)
    kw = dict(method=method, candidates="threshold", r=R, k=K)
    for make in ("single", "manual"):
        outs = []
        for dev in ("cpu", cuda):
            g = tree.tree_map(lambda t: t.to(dev), grads)
            ages = TS.init_age_state(g, method=method)
            sync = (TS.make_manual_sync(make_host_mesh(1, 1, device=dev),
                                        None, shapes, validate=True, **kw)
                    if make == "manual" else
                    lambda g_, a_: TS.sync_grads(g_, a_, **kw))
            res = []
            for _ in range(2):
                s, ages, st = sync(g, ages)
                res.append((tree.tree_map(lambda t: t.cpu(), s),
                            tree.tree_map(lambda t: t.cpu(), ages),
                            {k: int(v) for k, v in st.items()}))
            outs.append(res)
        for (s0, a0, st0), (s1, a1, st1) in zip(*outs):
            assert st0 == st1
            for x, y in zip(tree.leaves(s1) + tree.leaves(a1),
                            tree.leaves(s0) + tree.leaves(a0)):
                assert torch.equal(x, y)
