"""The port's LM training (``models.transformer.loss_fn`` and
``chunked_xent``, the tree optimizers, ``data.token_stream``,
``launch.steps.make_train_step``) against the JAX package, on
internlm2-1.8b's smoke config (2 layers, d 128, H 4, G 2, d_ff 256,
vocab 512) and inputs made from a seed with numpy.

Both packages start from the reference's ``T.init(cfg, PRNGKey(0))``
parameters, carried across by ``weights.params_from_jax``. Tolerances,
each with its reason:
- float32: losses within 1e-5 and gradients within 1e-4 absolute (the
  same float32 operations, summed in another order: about 1e-6 and 2e-7
  seen), and each gradient leaf within 1e-5 of its norm (2.2e-6 seen).
- bfloat16: losses within 5e-3 (about 2e-4 seen on a loss of 6.3, where a
  bfloat16 step of the activations is 2^-8 of them) and gradients within
  1e-2 absolute (about 3e-3 seen on gradients up to 0.18, a few
  bfloat16 steps of 2^-10 there: the two sum bfloat16 products in other
  orders and round the activations at other places). Most entries lie
  far below 1e-2, so each leaf is also held within 3e-2 of its norm
  (1.5e-2 seen, a few bfloat16 steps of 2^-8; a wrong gradient is off
  by the order of its norm).
- the optimizers: within 1e-6 relative (the same float32 formulas; XLA
  may fuse a multiply and an add).
- ``make_train_step``: after two steps from the same parameters, losses
  within 1e-5 and parameters within 1e-4 absolute, a tenth of one Adam
  step of lr 1e-3 (Adam divides by sqrt(v) + eps, so a gradient near 0
  turns its last-bit differences into a few 1e-5 of step: 1.5e-5 seen).
Token streams are numpy's in both packages and equal bit for bit;
rematerialization changes no bit.
"""
import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_smoke_config
from repro.configs.base import InputShape as JShape
from repro.data.pipeline import token_stream as j_token_stream
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import transformer as JT
from repro.optim import optimizers as JO

from repro_torch import tree
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.data import token_stream
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_model
from repro_torch.optim import optimizers as TO
from repro_torch.weights import opt_state_from_jax, params_from_jax

ARCH = "internlm2-1.8b"
TOL = {"float32": dict(loss=1e-5, grad=1e-4, grad_rel=1e-5),
       "bfloat16": dict(loss=5e-3, grad=1e-2, grad_rel=3e-2)}
B, S = 2, 40


def _np(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_grad_close(got, want, tol):
    """Element by element within ``tol['grad']``, and the leaf as a whole
    within ``tol['grad_rel']`` of its norm: the second holds the many
    entries far below the absolute tolerance."""
    g, w = _np(got), _np(want)
    np.testing.assert_allclose(g, w, atol=tol["grad"], rtol=tol["grad"])
    rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    assert rel <= tol["grad_rel"], rel


def _carry(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _batch(seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (b, s)).astype(np.int32)
    labels = rng.integers(0, 512, (b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def reference(request):
    """The reference's loss and gradients on the smoke config, once per
    dtype for the module's cases."""
    dtype = request.param
    jcfg = j_smoke_config(ARCH).replace(dtype=dtype, remat=False)
    tcfg = get_smoke_config(ARCH).replace(dtype=dtype, remat=False)
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    jb, tb = _batch()
    (loss, _aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True))(jparams, jb)
    return dict(dtype=dtype, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=_carry(jparams), tbatch=tb, loss=float(loss),
                grads=jax.tree_util.tree_leaves(grads))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_,chunk", [(40, 16), (32, 256)])
def test_chunked_xent_matches(dtype, S_, chunk):
    """Loss and gradients of x and w; a sequence that the chunk cuts with
    padding, and one shorter than the chunk."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S_, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 1024)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 1000, (2, S_)).astype(np.int32)
    jdt = jnp.dtype(dtype)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    want, (gx, gw) = jax.value_and_grad(
        lambda a, b: JT.chunked_xent(a, b, jnp.asarray(labels), 1000,
                                     chunk=chunk), argnums=(0, 1))(jx, jw)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    tw = torch.from_numpy(w).to(getattr(torch, dtype)).requires_grad_(True)
    got = TT.chunked_xent(tx, tw, torch.from_numpy(labels), 1000,
                          chunk=chunk)
    got.backward()
    tol = TOL[dtype]
    np.testing.assert_allclose(float(got.detach()), float(want),
                               atol=tol["loss"],
                               rtol=tol["loss"])
    for a, b in ((tx.grad, gx), (tw.grad, gw)):
        assert a.dtype == getattr(torch, dtype)
        _assert_grad_close(a, b, tol)


def test_chunked_xent_remat_keeps_no_chunk_logits():
    """With ``remat`` each chunk's logits are recomputed in the backward:
    the loss and the gradients of x and w are bitwise those without it,
    and autograd keeps none of the chunks' float32 (B, c, Vp) logits
    (only the checkpoints' inputs), where without it it keeps each
    chunk's."""
    rng = np.random.default_rng(2)
    B, S, d, Vp, chunk = 2, 64, 32, 1024, 16
    x = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((d, Vp)) * 0.1).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 1000, (B, S)))
    out = {}
    for remat in (False, True):
        tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
        saved = []

        def pack(t):
            saved.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = TT.chunked_xent(tx, tw, labels, 1000, chunk=chunk,
                                   remat=remat)
        loss.backward()
        out[remat] = (loss.detach(), tx.grad, tw.grad, saved)
    for a, b in zip(out[False][:3], out[True][:3]):
        assert torch.equal(a, b)
    logits = (B, chunk, Vp)
    assert out[False][3].count(logits) >= S // chunk
    assert logits not in out[True][3]


def test_loss_fn_matches(reference):
    """``loss_fn``'s value and its gradient by autograd against
    ``jax.value_and_grad``, every leaf in ``tree_leaves`` order."""
    ref = reference
    (loss, aux), grads = tree.value_and_grad(
        lambda p, b: TT.loss_fn(p, ref["tcfg"], b), ref["tparams"],
        ref["tbatch"], has_aux=True)
    tol = TOL[ref["dtype"]]
    np.testing.assert_allclose(float(loss), ref["loss"], atol=tol["loss"],
                               rtol=tol["loss"])
    assert float(aux["lb_loss"]) == 0.0
    leaves = tree.leaves(grads)
    assert len(leaves) == len(ref["grads"])
    for got, want, p in zip(leaves, ref["grads"],
                            tree.leaves(ref["tparams"])):
        assert tuple(got.shape) == want.shape
        assert got.dtype == p.dtype
        _assert_grad_close(got, want, tol)


def test_registry_carries_loss_fn():
    assert get_model(get_smoke_config(ARCH)).loss_fn is TT.loss_fn


@pytest.mark.parametrize("policy", ["full", "save_dots"])
def test_remat_is_bitwise(reference, policy):
    """``cfg.remat`` recomputes each layer in the backward pass and
    changes no bit of the loss or of any gradient."""
    ref = reference
    outs = []
    for remat in (False, True):
        cfg = ref["tcfg"].replace(remat=remat, remat_policy=policy)
        outs.append(tree.value_and_grad(
            lambda p, b: TT.loss_fn(p, cfg, b)[0], ref["tparams"],
            ref["tbatch"]))
    (l0, g0), (l1, g1) = outs
    assert torch.equal(l0, l1)
    for a, b in zip(tree.leaves(g0), tree.leaves(g1)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_token_stream_bitwise(seed):
    a = token_stream(512, 4, 33, seed=seed)
    b = j_token_stream(512, 4, 33, seed=seed)
    for _ in range(3):
        x, y = next(a), next(b)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])


# ---------------------------------------------------------------------------
# the tree optimizers
# ---------------------------------------------------------------------------

def _tree_pair(seed=3):
    """A parameter tree with a float32 and a bfloat16 leaf, in both
    packages, and three gradient trees."""
    rng = np.random.default_rng(seed)

    def one():
        return {"w": rng.standard_normal((6, 5)).astype(np.float32),
                "sub": {"b": rng.standard_normal((5,)).astype(np.float32)}}
    p = one()
    jp = {"w": jnp.asarray(p["w"]),
          "sub": {"b": jnp.asarray(p["sub"]["b"]).astype(jnp.bfloat16)}}
    grads = [one() for _ in range(3)]
    return jp, grads


@pytest.mark.parametrize("name,kw", [
    ("adam", dict()), ("adam", dict(weight_decay=0.01)),
    ("adam", dict(b1=0.8, eps=1e-6)), ("sgd", dict()),
    ("sgd", dict(momentum=0.9))])
def test_tree_optimizers_match(name, kw):
    """Three steps of the tree optimizers against the reference's pytree
    ones: updates, moments, step and the applied parameters (the
    bfloat16 leaf cast back to bfloat16)."""
    jp, grads = _tree_pair()
    jopt = getattr(JO, name)(1e-2, **kw)
    topt = getattr(TO, name)(1e-2, **kw)
    js = jopt.init(jp)
    tp = _carry(jp)
    ts = topt.init(tp)
    assert ts.step.shape == () and ts.step.dtype == torch.int32
    for g in grads:
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(params_from_jax(g, "cpu"), ts, tp)
        jp = JO.apply_updates(jp, ju)
        tp = TO.apply_updates(tp, tu)
        for a, b in zip(tree.leaves(tu), jax.tree_util.tree_leaves(ju)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                       atol=1e-9)
        for a, b in zip(tree.leaves(ts.mu), jax.tree_util.tree_leaves(js.mu)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-9)
        if name == "adam":
            for a, b in zip(tree.leaves(ts.nu),
                            jax.tree_util.tree_leaves(js.nu)):
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                           atol=1e-12)
        assert int(ts.step) == int(js.step)
    for a, b in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-7)


def test_opt_state_carried_from_reference():
    """The reference's state after two Adam steps, carried across, gives
    the port's third step the reference's."""
    jp, grads = _tree_pair(4)
    jopt, topt = JO.adam(1e-2, weight_decay=0.1), TO.adam(1e-2,
                                                          weight_decay=0.1)
    js = jopt.init(jp)
    for g in grads[:2]:
        _, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert int(ts.step) == 2
    ju, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads[2]), js,
                        jp)
    tu, _ = topt.update(params_from_jax(grads[2], "cpu"), ts, _carry(jp))
    for a, b in zip(tree.leaves(tu), jax.tree_util.tree_leaves(ju)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-9)


def test_flat_adam_path_unchanged():
    """The engine's stacked flat path (one tensor, per-row steps): bitwise
    the formula it had before tree states were added."""
    gen = torch.Generator().manual_seed(5)
    p = torch.randn((3, 7), generator=gen)
    opt = TO.adam(lambda s: 1e-3 * s.to(torch.float32))
    st = opt.init(p, batch_dims=1)
    assert st.step.shape == (3,)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for t in range(1, 4):
        g = torch.randn((3, 7), generator=gen)
        u, st = opt.update(g, st, p)
        sf = torch.full((3,), t, dtype=torch.float32)
        b1t = (1 - torch.pow(0.9, sf)).reshape(3, 1)
        b2t = (1 - torch.pow(0.999, sf)).reshape(3, 1)
        m = 0.9 * m + (1 - 0.9) * g
        v = 0.999 * v + (1 - 0.999) * g * g
        lr_t = (1e-3 * sf).reshape(3, 1)
        want = -lr_t * (m / b1t) / (torch.sqrt(v / b2t) + 1e-8)
        assert torch.equal(u, want)
        assert torch.equal(st.mu, m) and torch.equal(st.nu, v)


# ---------------------------------------------------------------------------
# the step builders
# ---------------------------------------------------------------------------

def test_make_train_step_grad_accum_matches():
    """``grad_accum`` 2 (float32 sums of the two microbatches' gradients,
    divided) and Adam, two steps, against the reference's
    ``make_train_step`` from the same parameters and batches."""
    jcfg = j_smoke_config(ARCH).replace(dtype="float32",
                                        grad_accum={"t": 2})
    tcfg = get_smoke_config(ARCH).replace(dtype="float32",
                                          grad_accum={"t": 2})
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(j_make_train_step(jcfg, JShape("t", 16, 4, "train"),
                                      lr=1e-3))
    tstep = make_train_step(tcfg, InputShape("t", 16, 4, "train"), lr=1e-3)
    js = JO.adam(1e-3).init(jparams)
    tp, ts = _carry(jparams), TO.adam(1e-3).init(_carry(jparams))
    jp = jparams
    for seed in (7, 8):
        jb, tb = _batch(seed, b=4, s=16)
        jp, js, jl = jstep(jp, js, jb)
        tp, ts, tl = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5,
                                   rtol=1e-5)
    for a, b in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=1e-5)


def test_prefill_and_decode_steps_wrap_the_model(reference):
    ref = reference
    cfg = ref["tcfg"]
    logits = make_prefill_step(cfg)(ref["tparams"], ref["tbatch"])
    assert torch.equal(logits, TT.prefill(ref["tparams"], cfg,
                                          ref["tbatch"]))
    cache = TT.init_cache(cfg, B, 4, device="cpu")
    out, _ = make_decode_step(cfg)(ref["tparams"],
                                   {"token": ref["tbatch"]["tokens"][:, 0]},
                                   cache, 0)
    assert out.shape == (B, cfg.padded_vocab)
