"""The port's mixture of experts (``repro_torch.models.moe``) and
granite-moe-3b-a800m (40 experts, top-8, GQA 24/8 at full width) against
the JAX package, on the CPU: the routing units, ``apply_moe``, the arch's
smoke config (4 experts, top-2) through ``tests/lm_parity.py``'s checks,
the training step with MoE's load-balance term, every gradient sync on
its 12-bucket tree (a float32 router beside bfloat16 expert stacks),
and the train and serve command lines.

Routing is integer output, held exactly: expert ids, positions in an
expert, the keep mask, the capacity. ``apply_moe`` in float32: y within
1e-5, ``lb_loss`` within 1e-6 and ``drop_frac`` within 1e-7 (XLA's
jitted 1 - mean(keep) may round off exactly 0 by an ulp), gradients
within 1e-5 (the same float32 operations summed in another order);
three routers: zero (every logit ties, so each token takes experts
0..K-1 and the drops are known in advance), a capacity factor of 0.25
(drops), random, and with a shared expert. In bfloat16 (the same
bfloat16 inputs to both) y within 2e-2, one bfloat16 step of the value
where the two round products differently: the reference's CPU computes
the expert products bfloat16 in and out, the port sums them in float32.
The syncs, given the same gradients, agree exactly (picks, ages, stats);
the command line's losses over 5 steps within 2e-3 of the reference's
loop from the port's carried weights (bfloat16: they round activations
in other places).
"""
import dataclasses
import re

import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke_config
from repro.configs.base import InputShape as JShape
from repro.dist import sparse_sync as JS
from repro.launch.mesh import make_host_mesh as j_mesh
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.optim import optimizers as JO

import lm_parity as P
import sync_ranks
from repro_torch import tree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.dist import sparse_sync as TS
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_model
from repro_torch.optim import optimizers as TO

ARCH = "granite-moe-3b-a800m"
R, K = 512, 64                  # the sync's budget on the smoke tree


def _cfgs(dtype="float32", **kw):
    return (j_smoke_config(ARCH).replace(dtype=dtype, **kw),
            get_smoke_config(ARCH).replace(dtype=dtype, **kw))


# ---------------------------------------------------------------------------
# routing and apply_moe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 2.0])
def test_capacity_matches(cf):
    for T in (1, 2, 7, 48, 1000, 8192):
        for k in (1, 2, 6, 8):
            for E in (4, 40, 160):
                jcfg, tcfg = _cfgs(capacity_factor=cf, experts_per_token=k,
                                   n_experts=E)
                c = TM.capacity(tcfg, T)
                assert c == JM.capacity(jcfg, T)
                assert c >= 8 and c % 8 == 0


def test_top_k_breaks_ties_to_the_lower_index():
    """Logits on a coarse grid (many ties), against ``lax.top_k``: values
    and ids exactly."""
    a = np.random.default_rng(0).integers(-3, 4, (200, 40)).astype(
        np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(a), 8)
    got_v, got_i = TM.top_k(torch.from_numpy(a), 8)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("TK,E", [(6, 4), (231, 4), (1024, 40),
                                  (4098, 160)])
def test_position_in_expert_matches(TK, E):
    """Random ids; 231 = 3 * 7 * 11 and 4,098 = 2 * 2,049 leave the
    reference's chunked prefix sum odd chunks."""
    ids = np.random.default_rng(TK).integers(0, E, TK).astype(np.int32)
    want = JM._position_in_expert(jnp.asarray(ids), E)
    got = TM._position_in_expert(torch.from_numpy(ids).long(), E)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


ROUTERS = {"zero": dict(), "low_capacity": dict(capacity_factor=0.25),
           "random": dict(), "shared": dict(n_shared_experts=1)}


def _moe_case(router, dtype):
    jcfg, tcfg = _cfgs(dtype, **ROUTERS[router])
    jp = JM.moe_params(jax.random.PRNGKey(5), jcfg)
    if router == "zero":
        jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    x = np.random.default_rng(6).standard_normal((2, 24, 128)).astype(
        np.float32)
    return jcfg, tcfg, jp, x


def _reference_routing(jp, jcfg, x):
    """The reference's routing, step by step as its ``apply_moe``."""
    T = x.shape[0] * x.shape[1]
    logits = jnp.asarray(x).reshape(T, -1).astype(jnp.float32) @ jp["router"]
    _, ids = jax.lax.top_k(logits, jcfg.experts_per_token)
    pos = JM._position_in_expert(ids.reshape(-1), jcfg.n_experts)
    return np.asarray(ids), np.asarray(pos), np.asarray(
        pos < JM.capacity(jcfg, T))


@pytest.mark.parametrize("router", list(ROUTERS))
def test_apply_moe_matches(router):
    """float32: routing exactly; y, lb_loss, drop_frac; and the gradients
    of <y, c> + lb_loss with respect to x and every parameter."""
    jcfg, tcfg, jp, x = _moe_case(router, "float32")
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)

    def jf(p, xx):
        y, aux = JM.apply_moe(p, jcfg, xx)
        return jnp.sum(y * cot) + aux["lb_loss"], (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = P.carry(jp)
    r = TM.route(tp["router"], tcfg, torch.from_numpy(x).reshape(48, 128))
    ids, pos, keep = _reference_routing(jp, jcfg, x)
    np.testing.assert_array_equal(r["ids"].numpy(), ids)
    np.testing.assert_array_equal(r["pos"].numpy(), pos)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)

    def tf(p, xx):
        y, aux = TM.apply_moe(p, tcfg, xx)
        return (y * torch.from_numpy(cot)).sum() + aux["lb_loss"], (y, aux)

    (_, (ty, taux)), tg = tree.value_and_grad(
        lambda t, _: tf(t["p"], t["x"]), {"p": tp, "x": torch.from_numpy(x)},
        None, has_aux=True)
    P.close(ty, jy, 1e-5)
    np.testing.assert_allclose(float(taux["lb_loss"]),
                               float(jaux["lb_loss"]), rtol=1e-6, atol=1e-6)
    assert float(taux["drop_frac"]) == pytest.approx(
        float(jaux["drop_frac"]), abs=1e-7)
    for got, want in zip(tree.leaves(tg["p"]) + [tg["x"]],
                         jax.tree_util.tree_leaves(jg[0]) + [jg[1]]):
        P.close(got, want, 1e-5)
    if router == "zero":
        K, T = tcfg.experts_per_token, 48
        C = TM.capacity(tcfg, T)
        assert (r["ids"] == torch.arange(K)).all()
        assert float(taux["drop_frac"]) == pytest.approx(1 - C / T, abs=1e-7)
        assert float(taux["lb_loss"]) == pytest.approx(1.0, abs=1e-6)
    if router == "low_capacity":
        assert 0 < float(taux["drop_frac"]) < 1


def test_apply_moe_bfloat16():
    jcfg, tcfg, jp, x = _moe_case("shared", "bfloat16")
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jy, jaux = JM.apply_moe(jp, jcfg, jx)
    ty, taux = TM.apply_moe(P.carry(jp), tcfg, torch.from_numpy(
        np.array(jx.astype(jnp.float32))).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    P.close(ty, jy, 2e-2)
    np.testing.assert_allclose(float(taux["lb_loss"]),
                               float(jaux["lb_loss"]), rtol=1e-6)
    assert float(taux["drop_frac"]) == pytest.approx(
        float(jaux["drop_frac"]), abs=1e-7)


# ---------------------------------------------------------------------------
# the arch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def ref(request):
    return P.reference(ARCH, request.param)


def test_params_carry_across_leaf_for_leaf(ref):
    P.check_init_tree(ref)


def test_decode_loop_matches_jax(ref):
    P.check_decode_loop(ref)


def test_generate_matches_jax_greedy(ref):
    P.check_generate(ref)


def test_prefill_matches_jax(ref):
    P.check_prefill(ref)


def test_decode_matches_own_prefill(ref):
    P.check_decode_matches_own_prefill(ref)


def test_loss_fn_matches(ref):
    """Including ``lb_loss``'s path through the router (0.01 of it in the
    loss), and the aux: lb_loss averaged over the layers, drop_frac."""
    P.check_loss(ref)
    assert ref["aux"]["drop_frac"] > 0          # the batch drops some


def test_remat_is_bitwise_with_aux():
    """``cfg.remat`` recomputes each block, its aux with it: no bit of
    the loss, the aux or a gradient changes."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32", remat=False)
    params = TT.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    batch = {k: torch.from_numpy(P.tokens((2, 24), s))
             for k, s in (("tokens", 1), ("labels", 2))}
    outs = [tree.value_and_grad(
        lambda p, b: TT.loss_fn(p, cfg.replace(remat=remat), b), params,
        batch, has_aux=True) for remat in (False, True)]
    ((l0, a0), g0), ((l1, a1), g1) = outs
    assert torch.equal(l0, l1) and all(torch.equal(a0[k], a1[k]) for k in a0)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g0),
                                                 tree.leaves(g1)))


def test_make_train_step_grad_accum_matches():
    """``grad_accum`` 2 and Adam, two steps, against the reference's
    ``make_train_step`` (the loss with its lb_loss term): losses within
    1e-5 and parameters within 1e-4, as ``tests/test_torch_lm_train.py``
    holds the dense arch."""
    jcfg, tcfg = _cfgs("float32", grad_accum={"t": 2})
    jp = JT.init(jcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(j_make_train_step(jcfg, JShape("t", 16, 4, "train"),
                                      lr=1e-3))
    tstep = make_train_step(tcfg, InputShape("t", 16, 4, "train"), lr=1e-3)
    js = JO.adam(1e-3).init(jp)
    tp = P.carry(jp)
    ts = TO.adam(1e-3).init(tp)
    for seed in (7, 8):
        b = {k: P.tokens((4, 16), seed + 10 * i)
             for i, k in enumerate(("tokens", "labels"))}
        jp, js, jl = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tl = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5,
                                   rtol=1e-5)
    for a, b in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(P.np_(a), P.np_(b), atol=1e-4, rtol=1e-5)


def test_config_matches_reference():
    for mine, theirs in ((get_config, j_config),
                         (get_smoke_config, j_smoke_config)):
        assert (dataclasses.asdict(mine(ARCH))
                == dataclasses.asdict(theirs(ARCH)))
        assert mine(ARCH).param_count() == theirs(ARCH).param_count()
        assert mine(ARCH).param_count(active_only=True) == \
            theirs(ARCH).param_count(active_only=True)
    assert get_config(ARCH).param_count() == 3_299_573_760
    assert get_model(get_config(ARCH)).loss_fn is TT.loss_fn


# ---------------------------------------------------------------------------
# the sparse sync on the MoE tree
# ---------------------------------------------------------------------------

def _grads(dtype):
    cfg = j_smoke_config(ARCH).replace(dtype=dtype, remat=False)
    params = JT.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: jnp.asarray(rng.integers(0, 512, (2, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    return jax.jit(jax.grad(lambda p, b: JT.loss_fn(p, cfg, b)[0]))(
        params, batch)


@pytest.fixture(scope="module")
def moe_grads(tmp_path_factory):
    """The reference's float32 and bfloat16 smoke-config gradients of one
    seeded batch (12 leaves; the router's float32 among bfloat16 ones in
    the second); the two-rank runs start here on the float32 ones."""
    g32, g16 = _grads("float32"), _grads("bfloat16")
    d = tmp_path_factory.mktemp("moe_ranks")
    procs = sync_ranks.start(
        [np.asarray(l) for l in jax.tree_util.tree_leaves(g32)], d, R, K)
    yield dict(float32=g32, bfloat16=g16, ranks=(d, procs))
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.communicate()


def _same(got, want):
    g, w = tree.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(P.np_(a), np.asarray(b).astype(
            P.np_(a).dtype))


def test_moe_tree_has_twelve_buckets(moe_grads):
    """12 leaves (a tied embedding); the router's gradient is float32
    beside the expert stacks' bfloat16, as the norms' scales are."""
    g = P.carry(moe_grads["bfloat16"])
    assert len(tree.leaves(g)) == 12
    moe = g["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert all(moe[k].dtype == torch.bfloat16
               for k in ("experts_w1", "experts_w2", "experts_w3"))


@pytest.mark.parametrize("method,cand,dtype", [
    ("rage_k", "sort", "float32"), ("rage_k", "threshold", "float32"),
    ("rage_k", "threshold", "bfloat16"), ("dense", "sort", "bfloat16")])
def test_sync_grads_on_moe_tree(moe_grads, method, cand, dtype):
    """``sync_grads`` against the reference's jitted
    ``make_sync_train_step`` (read through a linear loss and SGD at lr 1
    from zeros, as ``tests/test_torch_sparse_sync.py`` reads it), three
    calls from fresh ages: synced values, ages and wire bytes equal."""
    jg = moe_grads[dtype]
    tg = P.carry(jg)
    kw = dict(method=method, r=R, k=K, candidates=cand)
    opt = JO.sgd(1.0)
    step = jax.jit(JS.make_sync_train_step(
        lambda p, b: sum(jnp.sum(a * c) for a, c in zip(
            jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(b))),
        opt, None, **kw))
    p0 = jax.tree_util.tree_map(jnp.zeros_like, jg)
    jages = JS.init_age_state(jg, method=method)
    tages = TS.init_age_state(tg, method=method)
    for _ in range(3):
        p1, _, jages, _, jst = step(p0, opt.init(p0), jages, jg)
        tsyn, tages, tst = TS.sync_grads(tg, tages, **kw)
        _same(tsyn, jax.tree_util.tree_map(lambda x: -x, p1))
        _same(tages, jages)
        assert tst["wire_bytes_per_shard"] == int(jst["wire_bytes_per_shard"])
        assert [a.dtype for a in tree.leaves(tsyn)] == \
            [a.dtype for a in tree.leaves(tg)]


@pytest.mark.parametrize("buffer_k", [0, 2])
def test_manual_and_buffered_sync_on_moe_tree(moe_grads, buffer_k):
    """World size 1: ``make_manual_sync`` (rage_k on the threshold plane
    with the gate; unmasked, then the shard inactive) or
    ``make_buffered_sync`` (buffer_k 2, three calls) against the
    reference's on ``make_host_mesh(1, 1)``: synced values, ages, the
    buffer and every stat exactly."""
    jg = moe_grads["float32"]
    tg = P.carry(jg)
    shapes = jax.tree_util.tree_map(
        lambda g: jax.ShapeDtypeStruct(g.shape, g.dtype), jg)
    specs = jax.tree_util.tree_map(lambda _: PS(), jg)
    tshapes = tree.tree_map(lambda g: g.to("meta"), tg)
    kw = dict(method="rage_k", candidates="threshold", r=R, k=K,
              validate=not buffer_k)
    tmesh = make_host_mesh(1, 1, device="cpu")
    ja = JS.init_age_state_sharded(shapes)
    ta = TS.init_age_state_sharded(tshapes, device="cpu")
    if buffer_k:
        jbase = JS.make_buffered_sync(j_mesh(1, 1), specs, shapes,
                                      buffer_k=buffer_k, **kw)
        tsync = TS.make_buffered_sync(tmesh, None, tshapes,
                                      buffer_k=buffer_k, **kw)
        jsync, jbuf, tbuf = jax.jit(jbase), jbase.init_buffer(), \
            tsync.init_buffer()
        for _ in range(3):
            jsyn, ja, jbuf, jst = jsync(jg, ja, jbuf)
            tsyn, ta, tbuf, tst = tsync(tg, ta, tbuf)
            _same(tbuf.sums, jbuf.sums)
            _same(tsyn, jsyn)
            _same(ta, ja)
            assert {k: int(v) for k, v in tst.items()} == \
                {k: int(v) for k, v in jst.items()}
        return
    jsync = jax.jit(JS.make_manual_sync(j_mesh(1, 1), specs, shapes, **kw))
    tsync = TS.make_manual_sync(tmesh, None, tshapes, **kw)
    for act in (None, [False]):
        jsyn, ja, jst = jsync(jg, ja, active=None if act is None
                              else jnp.asarray(act))
        tsyn, ta, tst = tsync(tg, ta, active=None if act is None
                              else torch.tensor(act))
        _same(tsyn, jsyn)
        _same(ta, ja)
        assert {k: int(v) for k, v in tst.items()} == \
            {k: int(v) for k, v in jst.items()}


@pytest.fixture(scope="module")
def two_ranks(moe_grads):
    return sync_ranks.collect(*moe_grads["ranks"])


def test_two_ranks_on_moe_tree(two_ranks):
    """``tests/sync_ranks.py``'s scenarios on two gloo ranks over the 12
    buckets: the ranks agree; identical gradients == the reference's
    manual sync on a 2-device mesh; distinct ones == the numpy oracle of
    the union semantics; exactly."""
    sync_ranks.check_ranks_agree(two_ranks)
    sync_ranks.check_identical_match_reference(two_ranks)
    sync_ranks.check_distinct_match_oracle(two_ranks)


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

def test_train_cli_matches_reference_loop(capsys):
    """``launch.train --arch granite-moe-3b-a800m --smoke --steps 5
    --device cpu``: the reference's lines; losses within 2e-3 of the
    reference CLI's loop (its ``launch/train.py`` body: the jitted
    ``make_sync_train_step``, Adam 1e-3, ``token_stream`` from seed 1)
    started from the port's seed-0 weights carried across, since the two
    CLIs draw their weights from different generators; wire bytes
    equal."""
    out = train.main(["--arch", ARCH, "--smoke", "--steps", "5",
                      "--log-every", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    n = sum(p.numel() for p in tree.leaves(out["params"]))
    assert lines[0] == f"arch={ARCH} params={n:,} method=rage_k"
    pat = re.compile(r"step +(\d+) loss=(\d+\.\d{4}) steps/s=\d+\.\d\d "
                     r"wire=(\d+\.\d\d)MiB/shard$")
    assert all(pat.match(l) for l in lines[1:]) and len(lines) == 6

    init = TT.init(get_smoke_config(ARCH).replace(remat=False),
                   torch.Generator().manual_seed(0), device="cpu")
    want, wire = P.reference_cli_losses(ARCH, P.to_jax(init), "rage_k", 5)
    np.testing.assert_allclose(out["losses"], want, atol=2e-3, rtol=0)
    assert out["wire_bytes"] == wire


def test_serve_cli_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"arch={ARCH} batch=2 prefill=")
    ids = [int(i) for i in lines[1].split(": ")[1].strip("[]").split(",")]
    assert len(ids) == 4 and all(0 <= i < 512 for i in ids)
