"""An LM arch's smoke config in the port against the JAX package, for the
family test modules (``tests/test_torch_dense_archs.py``,
``test_torch_moe.py``, ``test_torch_mla.py``, ``test_torch_ssm.py``,
``test_torch_hybrid.py``, ``test_torch_vlm.py``, ``test_torch_audio.py``).

:func:`reference` runs the reference once for a module fixture: its
``T.init(cfg, PRNGKey(0))`` parameters (QKV biases made nonzero, since
both packages start them at 0), the greedy serve loop of decode steps
(not for audio, whose module runs its own loops through
:func:`jax_feed`), the VLM's decode loop from ``embed`` inputs,
``prefill`` and ``loss_fn`` with its gradient on the family's inputs
(:func:`model_inputs`: tokens; the VLM's embeddings; audio's frames and
decoder tokens); the ``check_*`` functions hold the port, started from
the same parameters carried across by ``weights.params_from_jax``, to
each. A module may hand ``reference`` config fields to replace in both
packages' smoke configs (a sliding window), and tolerances that replace
the defaults below for its family, each stated with its reason in that
module's docstring. Float inputs are made in float32 with numpy and
rounded to the model dtype by each package (both round to nearest even,
so both get the same values).

Tolerances, each with its reason (the levels of ``tests/test_torch_lm.py``
and ``tests/test_torch_lm_train.py``). Logits are held within tol
relative plus tol times max(1, the step's largest |logit|) absolute:
an untied head (qwen1.5-110b) gives logits up to about 4, where a tied
embedding's stay below about 1.
- float32: logits within 1e-4 and caches within 1e-5 at every decode
  step, the greedy tokens equal; the loss within 1e-5, gradients within
  1e-4 and each leaf within 1e-5 of its norm (the same float32
  operations summed in another order). Routing, an integer output, is
  the same: a random float32 router makes near-ties improbable.
- bfloat16: logits within 3e-2 and caches within 5e-2 at every step
  (the two round activations in other places; the reference's decode
  layer also rounds q * scale and the softmax weights to bfloat16,
  which the port keeps in float32); the loss and MoE's aux within 5e-3
  of the reference's bfloat16 run. Gradients are held to the
  reference's float32 gradient of the same (bfloat16-valued) parameters,
  each leaf within 3e-2 of its norm (1.9% seen on every arch) and each
  entry within 5e-2 of the leaf's largest: the reference's CPU runs MoE's
  expert products bfloat16 in and out (its ``_ACC = None`` there), which
  puts its own bfloat16 gradient 5% from that float32 one, where the
  port sums them in float32 as the reference's TPU artifact does. Greedy
  tokens in bfloat16 may part from the reference's where two logits lie
  within its rounding, so ``generate`` is held to the port's own decode
  steps there.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_smoke_config
from repro.data.pipeline import token_stream as j_token_stream
from repro.dist import sparse_sync as JS
from repro.launch.mesh import make_host_mesh as j_mesh
from repro.models import transformer as JT
from repro.optim import optimizers as JO

from repro_torch import tree
from repro_torch.configs import get_smoke_config
from repro_torch.dist import sparse_sync as TS
from repro_torch.launch import serve
from repro_torch.models import transformer as TT
from repro_torch.weights import params_from_jax

TOL = {"float32": dict(logits=1e-4, cache=1e-5, loss=1e-5, grad=1e-4,
                       grad_rel=1e-5),
       "bfloat16": dict(logits=3e-2, cache=5e-2, loss=5e-3, grad=5e-2,
                        grad_rel=3e-2)}
B, P, GEN = 2, 8, 6
S_LOSS = 40


def np_(x):
    if torch.is_tensor(x):
        x = x.detach()
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)) if jnp.issubdtype(
        jnp.asarray(x).dtype, jnp.floating) else np.asarray(x)


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(np_(got), np_(want), atol=tol, rtol=tol,
                               err_msg=msg)


def close_logits(got, want, tol, msg=""):
    scale = max(1.0, float(np.abs(np_(want)).max()))
    np.testing.assert_allclose(np_(got), np_(want), atol=tol * scale,
                               rtol=tol, err_msg=msg)


def carry(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def model_inputs(cfg, b: int, s: int, seed: int, train: bool = False,
                 s_dec: int | None = None) -> dict:
    """numpy inputs of ``loss_fn`` (``train``) or ``prefill``: tokens (b,
    s); the VLM's embeds (b, s, d), standard normal; audio's frames (b,
    s, d) and decoder tokens (b, ``s_dec``); labels of the tokens'
    shape."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    if cfg.family == "vlm":
        out, lab = {"embeds": rng.standard_normal((b, s, d))}, (b, s)
    elif cfg.family == "audio":
        out = {"frames": rng.standard_normal((b, s, d)),
               "tokens": rng.integers(0, 512, (b, s_dec))}
        lab = (b, s_dec)
    else:
        out, lab = {"tokens": rng.integers(0, 512, (b, s))}, (b, s)
    if train:
        out["labels"] = rng.integers(0, 512, lab)
    return {k: v.astype(np.int32 if v.dtype.kind == "i" else np.float32)
            for k, v in out.items()}


def to_j(arrays: dict, dtype: str) -> dict:
    """numpy inputs as the reference's: floats rounded to ``dtype``."""
    return {k: jnp.asarray(v).astype(jnp.dtype(dtype))
            if v.dtype.kind == "f" else jnp.asarray(v)
            for k, v in arrays.items()}


def to_t(arrays: dict, dtype: str) -> dict:
    """numpy inputs as the port's (fresh tensors): floats rounded to
    ``dtype``."""
    return {k: torch.from_numpy(v.copy()).to(getattr(torch, dtype))
            if v.dtype.kind == "f" else torch.from_numpy(v.copy())
            for k, v in arrays.items()}


def to_jax(params):
    """The port's parameters as the reference's (bfloat16 through its
    16-bit patterns)."""
    import ml_dtypes

    def one(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())
    return {k: to_jax(v) if isinstance(v, dict) else one(v)
            for k, v in params.items()}


def reference_cli_losses(arch, params, method, steps):
    """The reference's train CLI loop (its ``launch/train.py`` body at the
    defaults: the jitted ``make_sync_train_step``, Adam 1e-3, r 2,048, k
    256, ``token_stream`` batch 8 x 128 from seed 1) on ``arch``'s smoke
    config from the given reference-tree parameters: per-step losses and
    the summed wire bytes."""
    cfg = j_smoke_config(arch).replace(remat=False)
    opt = JO.adam(1e-3)
    step = jax.jit(JS.make_sync_train_step(
        lambda p, b: JT.loss_fn(p, cfg, b)[0], opt, j_mesh(1, 1),
        method=method, r=2048, k=256))
    state, ages = opt.init(params), JS.init_age_state(params)
    stream = j_token_stream(cfg.vocab_size, 8, 128, seed=1)
    losses, wire = [], 0
    for _ in range(steps):
        batch = {k: jnp.asarray(v) for k, v in next(stream).items()}
        params, state, ages, loss, stats = step(params, state, ages, batch)
        losses.append(float(loss))
        wire += int(stats["wire_bytes_per_shard"])
    return losses, wire


def flat(t, path=()):
    out = {}
    for k, v in t.items():
        out.update(flat(v, path + (k,)) if isinstance(v, dict)
                   else {path + (k,): v})
    return out


def _nonzero_biases(jparams, dtype, seed=21):
    """The reference's params with random QKV biases (0.1 N(0, 1))."""
    attn = dict(jparams["layers"]["attn"])
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(
            rng.standard_normal(attn[name].shape).astype(np.float32) * 0.1
        ).astype(jnp.dtype(dtype))
    return {**jparams, "layers": {**jparams["layers"], "attn": attn}}


def jax_feed(jcfg, jparams, feeds, cache) -> list:
    """The reference's jitted ``decode_step`` fed ``feeds`` (numpy input
    dicts, one a step) from ``cache`` (its own tree): per step (logits,
    cache) as numpy."""
    step = jax.jit(lambda p, inp, c, pos: JT.decode_step(p, jcfg, inp, c,
                                                         pos))
    out = []
    for t, inp in enumerate(feeds):
        logits, cache = step(jparams, to_j(inp, jcfg.dtype), cache, t)
        out.append((np.asarray(logits),
                    {k: np_(v) for k, v in cache.items()}))
    return out


def _jax_loop(jcfg, jparams, prompts, gen):
    """The reference serve loop (greedy): per step (logits, cache), the
    generated tokens and the tokens fed."""
    n_tok = prompts.shape[1]
    cache = JT.init_cache(jcfg, B, n_tok + gen)
    step = jax.jit(lambda p, tok, c, pos: JT.decode_step(
        p, jcfg, {"token": tok}, c, pos))
    steps, toks, fed = [], [], []
    for t in range(n_tok + gen):
        if t < n_tok:
            tok = jnp.asarray(prompts[:, t])
        else:
            tok = jnp.argmax(steps[-1][0], -1).astype(jnp.int32)
            toks.append(np.array(tok))
        fed.append(np.array(tok))
        logits, cache = step(jparams, tok, cache, t)
        steps.append((np.asarray(logits),
                      {k: np_(v) for k, v in cache.items()}))
    return steps, np.stack(toks, 1), fed


def reference(arch: str, dtype: str, tol: dict | None = None,
              **fields) -> dict:
    """The reference's runs on ``arch``'s smoke config in ``dtype``, with
    ``fields`` replaced in both packages' configs; the checks hold the
    port to ``TOL[dtype]`` updated by ``tol``."""
    jcfg = j_smoke_config(arch).replace(dtype=dtype, remat=False, **fields)
    tcfg = get_smoke_config(arch).replace(dtype=dtype, remat=False,
                                          **fields)
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    if jcfg.qkv_bias:
        jparams = _nonzero_biases(jparams, dtype)
    prompts = tokens((B, P), 12)
    steps = toks = fed = embed_run = None
    if jcfg.family != "audio":
        steps, toks, fed = _jax_loop(jcfg, jparams, prompts, GEN)
    if jcfg.family == "vlm":
        e = np.random.default_rng(14).standard_normal(
            (B, P + GEN, jcfg.d_model)).astype(np.float32)
        feeds = [{"embed": e[:, t]} for t in range(P + GEN)]
        embed_run = dict(feeds=feeds, steps=jax_feed(
            jcfg, jparams, feeds, JT.init_cache(jcfg, B, P + GEN)))
    pre_in = model_inputs(jcfg, B, 12, 13, s_dec=12)
    pre = jax.jit(lambda p, b: JT.prefill(p, jcfg, b))(
        jparams, to_j(pre_in, dtype))
    batch = model_inputs(jcfg, B, S_LOSS, 0, train=True,
                         s_dec=jcfg.max_target_len)
    jbatch = to_j(batch, dtype)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True))(jparams, jbatch)
    if dtype != "float32":
        c32 = jcfg.replace(dtype="float32")

        def f32(a):
            return a.astype(jnp.float32) if jnp.issubdtype(
                a.dtype, jnp.floating) else a
        _, grads = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(p, c32, b), has_aux=True))(
            jax.tree_util.tree_map(f32, jparams),
            jax.tree_util.tree_map(f32, jbatch))
    return dict(arch=arch, dtype=dtype, tol={**TOL[dtype], **(tol or {})},
                jcfg=jcfg, tcfg=tcfg,
                jparams=jparams, tparams=carry(jparams), prompts=prompts,
                steps=steps, toks=toks, fed=fed, embed_run=embed_run,
                pre_in=pre_in, prefill=np.asarray(pre),
                batch=to_t(batch, dtype), batch_np=batch,
                loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                grads=jax.tree_util.tree_leaves(grads))


def check_init_tree(ref):
    """The reference's parameters carried leaf for leaf (shapes, dtypes,
    values), and the port's own init draws the same tree."""
    jleaves = jax.tree_util.tree_leaves_with_path(ref["jparams"])
    tflat = flat(ref["tparams"])
    if ref["tcfg"].qkv_bias:      # the bias path is exercised
        assert all(bool(tflat[("layers", "attn", b)].any())
                   for b in ("bq", "bk", "bv"))
    assert len(jleaves) == len(tflat)
    for path, leaf in jleaves:
        t = tflat[tuple(p.key for p in path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype) == f"torch.{leaf.dtype}"
        np.testing.assert_array_equal(np_(t), np_(leaf))
    mine = flat(TT.init(ref["tcfg"], torch.Generator().manual_seed(0),
                        device="cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tflat.items()}


def check_decode_loop(ref):
    """P + GEN decode steps from the same tokens: logits and every cache
    at every step; in float32 the greedy tokens too."""
    check_feed_loop(ref, [{"token": tok} for tok in ref["fed"]],
                    ref["steps"], TT.init_cache(ref["tcfg"], B, P + GEN,
                                                device="cpu"))


def check_feed_loop(ref, feeds, steps, cache):
    """The port's ``decode_step`` fed ``feeds`` (numpy input dicts) from
    ``cache`` against the reference's ``steps`` (:func:`jax_feed`):
    logits and every cache at every step; in float32 the argmax too."""
    tcfg, tol = ref["tcfg"], ref["tol"]
    assert set(cache) == set(steps[0][1])
    for t, (inp, (jlogits, jcache)) in enumerate(zip(feeds, steps)):
        logits, cache = TT.decode_step(ref["tparams"], tcfg,
                                       to_t(inp, ref["dtype"]), cache, t)
        assert logits.dtype == torch.float32
        assert logits.shape == (B, tcfg.padded_vocab)
        close_logits(logits, jlogits, tol["logits"], f"logits, step {t}")
        for name, want in jcache.items():
            assert tuple(cache[name].shape) == want.shape
            close(cache[name], want, tol["cache"], f"{name}, step {t}")
        if ref["dtype"] == "float32":
            np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                          jlogits.argmax(-1))


def check_generate(ref):
    """``serve.generate`` greedy: in float32 the reference's tokens and
    last logits; in bfloat16 the port's own decode steps', bitwise."""
    tcfg = ref["tcfg"]
    prompts = torch.from_numpy(ref["prompts"])
    out = serve.generate(ref["tparams"], tcfg, prompts, GEN)
    assert out.finite and out.tokens.shape == (B, GEN)
    if ref["dtype"] == "float32":
        close_logits(out.logits, ref["steps"][-1][0],
                     ref["tol"]["logits"])
        np.testing.assert_array_equal(out.tokens.numpy(), ref["toks"])
        return
    cache = TT.init_cache(tcfg, B, P + GEN, device="cpu")
    toks = []
    for t in range(P + GEN):
        tok = prompts[:, t] if t < P else logits.argmax(-1)
        if t >= P:
            toks.append(tok)
        logits, cache = TT.decode_step(ref["tparams"], tcfg, {"token": tok},
                                       cache, t)
    assert torch.equal(out.tokens, torch.stack(toks, 1))
    assert torch.equal(out.logits, logits)


def check_prefill(ref):
    got = TT.prefill(ref["tparams"], ref["tcfg"],
                     to_t(ref["pre_in"], ref["dtype"]))
    assert got.dtype == torch.float32
    close_logits(got, ref["prefill"], ref["tol"]["logits"])


def check_decode_matches_own_prefill(ref):
    """Step-by-step decode reproduces the forward pass's last logits
    (at the logits' tolerance: in bfloat16 the two paths round
    activations differently).
    Under MoE at a capacity that drops nothing (cf E / K: C >= T), since
    a decode step routes B tokens against its own capacity and the
    forward pass B * S, whose drops a decode step never makes. The VLM's
    steps take the prefill's embeddings, one ``embed`` a step."""
    tcfg = ref["tcfg"]
    if tcfg.is_moe:
        tcfg = tcfg.replace(
            capacity_factor=tcfg.n_experts / tcfg.experts_per_token)
    inputs = to_t(ref["pre_in"], ref["dtype"])
    full = TT.prefill(ref["tparams"], tcfg, inputs)
    seq = inputs["embeds" if tcfg.family == "vlm" else "tokens"]
    name = "embed" if tcfg.family == "vlm" else "token"
    cache = TT.init_cache(tcfg, B, seq.shape[1], device="cpu")
    for t in range(seq.shape[1]):
        logits, cache = TT.decode_step(ref["tparams"], tcfg,
                                       {name: seq[:, t]}, cache, t)
    close_logits(logits, full, ref["tol"]["logits"])


def check_loss(ref):
    """``loss_fn``'s value, aux and every gradient leaf (dtype, shape,
    values) against ``jax.value_and_grad`` of the reference's (in
    bfloat16 its float32 model's gradient, as the module's docstring
    says)."""
    tol = ref["tol"]
    (loss, aux), grads = tree.value_and_grad(
        lambda p, b: TT.loss_fn(p, ref["tcfg"], b), ref["tparams"],
        ref["batch"], has_aux=True)
    np.testing.assert_allclose(float(loss), ref["loss"], atol=tol["loss"],
                               rtol=tol["loss"])
    assert set(aux) == set(ref["aux"])
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), ref["aux"][k],
                                   atol=tol["loss"], rtol=tol["loss"],
                                   err_msg=k)
    leaves = tree.leaves(grads)
    assert len(leaves) == len(ref["grads"])
    for got, want, p in zip(leaves, ref["grads"],
                            tree.leaves(ref["tparams"])):
        assert tuple(got.shape) == want.shape and got.dtype == p.dtype
        g, w = np_(got), np_(want)
        if ref["dtype"] == "float32":
            np.testing.assert_allclose(g, w, atol=tol["grad"],
                                       rtol=tol["grad"])
        else:
            np.testing.assert_allclose(
                g, w, atol=tol["grad"] * np.abs(w).max(), rtol=0)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= tol["grad_rel"], rel


def check_sync_grads(arch: str, r: int, k: int):
    """One ``sync_grads`` call (rage_k on the threshold plane) on the
    reference's bfloat16 smoke-config gradient of a :func:`model_inputs`
    batch (B 2, seq 32) against its jitted ``make_sync_train_step`` (read
    through a linear loss and SGD at lr 1 from zeros, as
    ``tests/test_torch_sparse_sync.py`` reads it): synced values, ages
    and wire bytes equal, each bucket in its own dtype. Returns the
    carried gradient."""
    cfg = j_smoke_config(arch).replace(dtype="bfloat16", remat=False)
    params = JT.init(cfg, jax.random.PRNGKey(0))
    batch = to_j(model_inputs(cfg, 2, 32, 0, train=True,
                              s_dec=cfg.max_target_len), "bfloat16")
    jg = jax.jit(jax.grad(lambda p, b: JT.loss_fn(p, cfg, b)[0]))(params,
                                                                  batch)
    tg = carry(jg)
    kw = dict(method="rage_k", r=r, k=k, candidates="threshold")
    opt = JO.sgd(1.0)
    step = jax.jit(JS.make_sync_train_step(
        lambda p, b: sum(jnp.sum(a * c) for a, c in zip(
            jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(b))),
        opt, None, **kw))
    p0 = jax.tree_util.tree_map(jnp.zeros_like, jg)
    p1, _, jages, _, jst = step(p0, opt.init(p0), JS.init_age_state(jg), jg)
    tsyn, tages, tst = TS.sync_grads(tg, TS.init_age_state(tg), **kw)
    for got, want in ((tsyn, jax.tree_util.tree_map(lambda x: -x, p1)),
                      (tages, jages)):
        for a, b in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np_(a), np.asarray(b).astype(
                np_(a).dtype))
    assert tst["wire_bytes_per_shard"] == int(jst["wire_bytes_per_shard"])
    assert [a.dtype for a in tree.leaves(tsyn)] == \
        [a.dtype for a in tree.leaves(tg)]
    return tg
