"""Model, flattening, optimizer and local phase of the port against the
JAX package, from the reference's own initial parameters handed over with
``params_from_jax``. Floats within rtol=1e-5, atol=1e-6 (float32 sums in
another order); candidate indices exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

from repro.fl import client as JC
from repro.models import paper_nets as JP
from repro.optim import optimizers as JO

from repro_torch.fl import client as TC
from repro_torch.models import paper_nets as TP
from repro_torch.optim import optimizers as TO
from repro_torch.weights import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def test_mlp_size_and_flatten_order():
    jparams = JP.mlp_init(jax.random.PRNGKey(0))
    tparams = TP.mlp_init(torch.Generator().manual_seed(0), "cpu")
    assert TP.param_count(tparams) == JP.param_count(jparams) == 39_760
    assert ([tuple(l.shape) for l in TC.tree_leaves(tparams)]
            == [l.shape for l in jax.tree_util.tree_leaves(jparams)]
            == [(50,), (784, 50), (10,), (50, 10)])
    flat = TC.flatten_tree(params_from_jax(_np_tree(jparams), "cpu"))
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(JC.flatten_tree(jparams)))
    back = TC.unflattener(tparams)(flat)
    for a, b in zip(TC.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mlp_logits_match_single_and_stacked():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 16, 28, 28, 1)).astype(np.float32)
    jtrees = [JP.mlp_init(jax.random.PRNGKey(i)) for i in range(3)]
    want = np.stack([np.asarray(JP.mlp_apply(p, jnp.asarray(x[i])))
                     for i, p in enumerate(jtrees)])
    ttrees = [params_from_jax(_np_tree(p), "cpu") for p in jtrees]
    _close(TP.mlp_apply(ttrees[1], torch.from_numpy(x[1])), want[1])
    stacked = TC.unflattener(ttrees[0])(
        torch.stack([TC.flatten_tree(t) for t in ttrees]))
    _close(TP.mlp_apply(stacked, torch.from_numpy(x)), want)


@pytest.mark.parametrize("impl", ["threshold", "sort"])
def test_local_phase_matches(impl):
    """Three clients, H = 3 Adam steps from the reference's initial
    params: per-client losses, last-step gradients, Adam state and the
    fused top-r report."""
    n, H, B, r = 3, 3, 32, 75
    rng = np.random.default_rng(1)
    bx = rng.standard_normal((n, H, B, 28, 28, 1)).astype(np.float32)
    by = rng.integers(0, 10, (n, H, B)).astype(np.int32)
    jparams = JP.mlp_init(jax.random.PRNGKey(3))

    def jloss(params, state, batch):
        return JC.softmax_xent(JP.mlp_apply(params, batch[0]), batch[1]), state

    jps = JC.broadcast_global(jparams, n)
    jopt = jax.vmap(JO.adam(1e-3).init)(jps)
    _, jopt2, _, jG, jrep, jlosses = JC.make_local_phase(
        jloss, 1e-3, report_r=r, report_impl=impl)(
            jps, jopt, {}, (jnp.asarray(bx), jnp.asarray(by)))

    tparams = params_from_jax(_np_tree(jparams), "cpu")
    flat = TC.broadcast_global(TC.flatten_tree(tparams), n)
    topt = TO.adam(1e-3).init(flat, batch_dims=1)

    def tloss(tree, state, x, y):
        return TC.softmax_xent(TP.mlp_apply(tree, x), y), state

    _, topt2, tstate, tG, trep, tlosses = TC.make_local_phase(
        tloss, TC.unflattener(tparams), 1e-3, report_r=r,
        report_impl=impl)(flat, topt, {}, torch.from_numpy(bx),
                          torch.from_numpy(by).long())
    assert tstate == {}
    _close(tlosses, jlosses)
    _close(tG, jG)
    np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
    np.testing.assert_array_equal(topt2.step.numpy(), np.asarray(jopt2.step))
    _close(topt2.mu, jax.vmap(JC.flatten_tree)(jopt2.mu))
    _close(topt2.nu, jax.vmap(JC.flatten_tree)(jopt2.nu))


def test_adam_three_steps_match():
    rng = np.random.default_rng(2)
    p = rng.standard_normal((4, 300)).astype(np.float32)
    grads = [rng.standard_normal((4, 300)).astype(np.float32)
             * 10.0 ** rng.integers(-9, 2, (4, 300)) for _ in range(3)]
    jopt = JO.adam(1e-4)
    tone = TO.adam(1e-4)
    jp, jst = jnp.asarray(p), jopt.init(jnp.asarray(p))
    tp, tst = torch.from_numpy(p), tone.init(torch.from_numpy(p))
    tps = torch.from_numpy(p)
    tsts = tone.init(tps, batch_dims=1)          # per-row step counters
    for g in grads:
        ju, jst = jopt.update(jnp.asarray(g), jst, jp)
        jp = JO.apply_updates(jp, ju)
        tu, tst = tone.update(torch.from_numpy(g), tst, tp)
        tp = TO.apply_updates(tp, tu)
        tus, tsts = tone.update(torch.from_numpy(g), tsts, tps)
        tps = TO.apply_updates(tps, tus)
        _close(tu, ju)
    _close(tp, jp)
    _close(tst.mu, jst.mu)
    _close(tst.nu, jst.nu)
    assert int(tst.step) == int(jst.step) == 3
    assert tsts.step.tolist() == [3] * 4
    np.testing.assert_array_equal(tps.numpy(), tp.numpy())


def test_sgd_matches():
    rng = np.random.default_rng(3)
    p = rng.standard_normal(50).astype(np.float32)
    jopt, tone = JO.sgd(0.1, momentum=0.9), TO.sgd(0.1, momentum=0.9)
    jp, jst = jnp.asarray(p), jopt.init(jnp.asarray(p))
    tp, tst = torch.from_numpy(p), tone.init(torch.from_numpy(p))
    for _ in range(3):
        g = rng.standard_normal(50).astype(np.float32)
        ju, jst = jopt.update(jnp.asarray(g), jst, jp)
        jp = JO.apply_updates(jp, ju)
        tu, tst = tone.update(torch.from_numpy(g), tst, tp)
        tp = TO.apply_updates(tp, tu)
    _close(tp, jp)
