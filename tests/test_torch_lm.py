"""The port's LM serving slice (``repro_torch.models``, ``launch.serve``)
against the JAX package, on internlm2-1.8b's smoke config (2 layers,
d 128, H 4, G 2, d_ff 256, vocab 512) and inputs made from a seed with
numpy.

Both packages start from the reference's ``T.init(cfg, PRNGKey(0))``
parameters, carried across by ``weights.params_from_jax``. Tolerances,
each with its reason:
- float32: layers within 1e-5 (the same float32 operations, summed in
  another order); logits within 1e-4 and caches within 1e-5 at every
  decode step, greedy tokens equal.
- bfloat16: layers within 2e-2 (one bfloat16 step, 2^-8 of the value,
  where the two round a float32 result differently); logits within 3e-2
  (about 1.2e-2 seen, on logits up to 0.7) and caches within 5e-2 (one
  bfloat16 step of the K/V values, up to 2^-5 = 0.031 seen) at every
  step. Besides the rounding order, the reference's decode layer rounds
  q * scale and the softmax weights to bfloat16, which the port, like the
  TPU kernel, keeps in float32.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.configs import get_smoke_config as j_smoke_config
from repro.configs import list_archs as j_list_archs
from repro.models import layers as JL
from repro.models import transformer as JT

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_model
from repro_torch.weights import params_from_jax

ARCH = "internlm2-1.8b"
TOL = {"float32": dict(layer=1e-5, logits=1e-4, cache=1e-5),
       "bfloat16": dict(layer=2e-2, logits=3e-2, cache=5e-2)}
B, P, GEN = 2, 8, 6


def _cfgs(dtype, **kw):
    return (j_smoke_config(ARCH).replace(dtype=dtype, **kw),
            get_smoke_config(ARCH).replace(dtype=dtype, **kw))


def _np(x):
    if torch.is_tensor(x):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=msg)


def _carry(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _pair(a, dtype):
    return (jnp.asarray(a).astype(jnp.dtype(dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm_matches(dtype, norm):
    jcfg, tcfg = _cfgs(dtype, norm=norm)
    jx, tx = _pair(_rand((2, 5, 128), 0, 3.0), dtype)
    p = {"scale": _rand((128,), 1), "bias": _rand((128,), 2)}
    if norm == "rmsnorm":
        del p["bias"]
    got = TL.apply_norm(params_from_jax(p, "cpu"), tcfg, tx)
    assert got.dtype == tx.dtype
    _close(got, JL.apply_norm(p, jcfg, jx), TOL[dtype]["layer"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches(dtype, batched):
    """float32 within 5e-5 at positions up to 5000: XLA's and PyTorch's
    sin and cos of the same float32 angle differ by about 2e-5 there."""
    jx, tx = _pair(_rand((2, 6, 4, 32), 3), dtype)
    pos = (np.arange(6) + 11) if not batched else \
        np.random.default_rng(4).integers(0, 5000, (2, 6))
    got = TL.rope(tx, torch.from_numpy(pos), 10000.0)
    assert got.dtype == tx.dtype
    _close(got, JL.rope(jx, jnp.asarray(pos), 10000.0),
           5e-5 if dtype == "float32" else TOL[dtype]["layer"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type,act", [("glu", "silu"), ("dense", "gelu"),
                                          ("dense", "relu")])
def test_apply_mlp_matches(dtype, mlp_type, act):
    jcfg, tcfg = _cfgs(dtype, mlp_type=mlp_type, act=act)
    jp = JL.mlp_params(jax.random.PRNGKey(5), jcfg)
    jx, tx = _pair(_rand((2, 3, 128), 6), dtype)
    _close(TL.apply_mlp(_carry(jp), tcfg, tx), JL.apply_mlp(jp, jcfg, jx),
           TOL[dtype]["layer"])


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_qkv_matches(qkv_bias):
    jcfg, tcfg = _cfgs("float32", qkv_bias=qkv_bias)
    jp = JL.attention_params(jax.random.PRNGKey(7), jcfg)
    if qkv_bias:
        jp = {k: v + 0.1 if k.startswith("b") else v for k, v in jp.items()}
    jx, tx = _pair(_rand((2, 5, 128), 8), "float32")
    for got, want in zip(TL.qkv(_carry(jp), tcfg, tx), JL.qkv(jp, jcfg, jx)):
        assert tuple(got.shape) == want.shape
        _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(), dict(window=5), dict(causal=False),
                                dict(q_offset=3, kv_chunk=7)])
def test_flash_attention_matches(dtype, kw):
    jq, tq = _pair(_rand((2, 13, 4, 32), 9), dtype)
    jk, tk = _pair(_rand((2, 16, 2, 32), 10), dtype)
    jv, tv = _pair(_rand((2, 16, 2, 32), 11), dtype)
    kw = {"kv_chunk": 8, **kw}
    _close(TL.flash_attention(tq, tk, tv, **kw),
           JL.flash_attention(jq, jk, jv, **kw), TOL[dtype]["layer"])


# ---------------------------------------------------------------------------
# the slice: parameters, decode loop, prefill
# ---------------------------------------------------------------------------

def _prompts(n_tok=P, seed=12):
    return np.random.default_rng(seed).integers(0, 512, (B, n_tok)).astype(
        np.int32)


def _jax_loop(jcfg, jparams, prompts, gen):
    """The reference serve loop (greedy), as tests/test_models_smoke.py
    drives decode_step: per step (logits, cache), and the tokens."""
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
                      {k: _np(v) for k, v in cache.items()}))
    return steps, np.stack(toks, 1), fed


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def reference(request):
    dtype = request.param
    jcfg, tcfg = _cfgs(dtype)
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    prompts = _prompts()
    steps, toks, fed = _jax_loop(jcfg, jparams, prompts, GEN)
    return dict(dtype=dtype, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=_carry(jparams), prompts=prompts, steps=steps,
                toks=toks, fed=fed)


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict)
                   else {path + (k,): v})
    return out


def test_params_carry_across_leaf_for_leaf(reference):
    jleaves = jax.tree_util.tree_leaves_with_path(reference["jparams"])
    tflat = _flat(reference["tparams"])
    assert len(jleaves) == len(tflat)
    for path, leaf in jleaves:
        t = tflat[tuple(p.key for p in path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype) == f"torch.{leaf.dtype}"
        np.testing.assert_array_equal(_np(t), _np(leaf))
    # the port's own init draws the same tree, shapes and dtypes
    mine = _flat(TT.init(reference["tcfg"], torch.Generator().manual_seed(0),
                         device="cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tflat.items()}


def test_decode_loop_matches_jax(reference):
    """P + GEN decode steps from the same tokens: logits and both caches
    at every step; in float32 the greedy tokens too."""
    tcfg, tol = reference["tcfg"], TOL[reference["dtype"]]
    cache = TT.init_cache(tcfg, B, P + GEN, device="cpu")
    for t, (tok, (jlogits, jcache)) in enumerate(zip(reference["fed"],
                                                     reference["steps"])):
        logits, cache = TT.decode_step(reference["tparams"], tcfg,
                                       {"token": torch.from_numpy(tok)},
                                       cache, t)
        assert logits.dtype == torch.float32
        assert logits.shape == (B, tcfg.padded_vocab)
        _close(logits, jlogits, tol["logits"], f"logits, step {t}")
        for name in ("k", "v"):
            _close(cache[name], jcache[name], tol["cache"], f"{name}, step {t}")
        if reference["dtype"] == "float32":
            np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                          jlogits.argmax(-1))


def test_generate_matches_jax_greedy(reference):
    out = serve.generate(reference["tparams"], reference["tcfg"],
                         torch.from_numpy(reference["prompts"]), GEN)
    assert out.finite and out.tokens.shape == (B, GEN)
    _close(out.logits, reference["steps"][-1][0],
           TOL[reference["dtype"]]["logits"])
    if reference["dtype"] == "float32":
        np.testing.assert_array_equal(out.tokens.numpy(), reference["toks"])


def test_prefill_matches_jax(reference):
    toks = _prompts(12, seed=13)
    want = JT.prefill(reference["jparams"], reference["jcfg"],
                      {"tokens": jnp.asarray(toks)})
    got = TT.prefill(reference["tparams"], reference["tcfg"],
                     {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    _close(got, want, TOL[reference["dtype"]]["logits"])


def test_decode_matches_own_prefill(reference):
    """Step-by-step decode reproduces the forward pass's last logits, as
    tests/test_models_smoke.py checks the reference (3e-2: bfloat16
    activations take other roundings on the two paths)."""
    tcfg = reference["tcfg"]
    toks = torch.from_numpy(_prompts(12, seed=14))
    full = TT.prefill(reference["tparams"], tcfg, {"tokens": toks})
    cache = TT.init_cache(tcfg, B, 12, device="cpu")
    for t in range(12):
        logits, cache = TT.decode_step(reference["tparams"], tcfg,
                                       {"token": toks[:, t]}, cache, t)
    _close(logits, full, 3e-2 if reference["dtype"] == "bfloat16" else 1e-4)


def test_sliding_window_ring_buffer_matches_jax():
    """Under a sliding window the cache is a ring of 4 slots: 10 decode
    steps wrap it twice; prefill masks outside the window."""
    jcfg, tcfg = _cfgs("float32", sliding_window=4)
    jparams = JT.init(jcfg, jax.random.PRNGKey(1))
    tparams = _carry(jparams)
    prompts = _prompts(6, seed=15)
    steps, _, fed = _jax_loop(jcfg, jparams, prompts, 4)
    cache = TT.init_cache(tcfg, B, 10, device="cpu")
    assert cache["k"].shape[2] == 4
    for t, (tok, (jlogits, jcache)) in enumerate(zip(fed, steps)):
        logits, cache = TT.decode_step(tparams, tcfg,
                                       {"token": torch.from_numpy(tok)},
                                       cache, t)
        _close(logits, jlogits, 1e-4, f"step {t}")
        _close(cache["k"], jcache["k"], 1e-5, f"k, step {t}")
    _close(TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(prompts)}),
           JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompts)}), 1e-4)


def test_sampling_properties():
    """temperature > 0 draws from softmax(logits / T) with the caller's
    generator: tokens in range, reproducible by seed, different across
    seeds, and greedy as T -> 0."""
    tcfg = get_smoke_config(ARCH)
    params = TT.init(tcfg, torch.Generator().manual_seed(3), device="cpu")
    prompts = torch.from_numpy(_prompts(4, seed=16).astype(np.int64))

    def run(temp, seed):
        return serve.generate(params, tcfg, prompts, 8, temperature=temp,
                              generator=torch.Generator().manual_seed(seed)
                              ).tokens
    a, b, c = run(1.0, 0), run(1.0, 0), run(1.0, 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.padded_vocab
    assert torch.equal(run(1e-6, 0), serve.generate(params, tcfg, prompts,
                                                    8).tokens)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_bf16_tree_round_trips_bit_for_bit():
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -3e-39,
                        3.3e38, 1.0, -2.5, 1e-3], np.float32)
    a = np.concatenate([special, _rand((2 * 7 * 5 - 11,), 17)]
                       ).reshape(2, 7, 5).astype(ml_dtypes.bfloat16)
    tree = {"layers": {"w": a, "n": np.arange(6, dtype=np.int32)},
            "f": a.astype(np.float32)}
    got = params_from_jax(tree, "cpu")
    w = got["layers"]["w"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (2, 7, 5)
    np.testing.assert_array_equal(w.view(torch.int16).numpy().view(np.uint16),
                                  a.view(np.uint16))
    assert got["layers"]["n"].dtype == torch.int32
    assert got["f"].dtype == torch.float32
    np.testing.assert_array_equal(got["f"].numpy().view(np.uint32),
                                  tree["f"].view(np.uint32))


# ---------------------------------------------------------------------------
# entry points and what is not ported
# ---------------------------------------------------------------------------

def test_serve_cli_runs_on_the_cpu_when_asked():
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen",
         "4"], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=internlm2-1.8b batch=2 prefill=")
    assert lines[0].endswith("tok/s/batch")
    head = "generated token ids (first row): "
    assert lines[1].startswith(head)
    ids = eval(lines[1][len(head):])
    assert len(ids) == 4 and all(0 <= i < 512 for i in ids)


def test_serve_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--batch", "1", "--prompt-len", "2",
                    "--gen", "1"])
    cfg = get_smoke_config(ARCH)
    for call in (lambda: TT.init_cache(cfg, 1, 4),
                 lambda: TT.init(cfg, torch.Generator()),
                 lambda: get_model(cfg).init(cfg, torch.Generator())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_init_refuses_a_generator_on_another_device():
    """The parameters land where ``device`` says, never silently on the
    generator's device."""
    cfg = get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="generator"):
        TT.init(cfg, torch.Generator(), device="meta")
    params = TT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"]["w"].device.type == "cpu"


def test_registry_lists_every_reference_arch():
    assert list_archs() == j_list_archs()
    assert get_model(get_config(ARCH)).decode_step is TT.decode_step


@pytest.mark.parametrize("arch", [a for a in j_list_archs() if a != ARCH])
def test_unported_arch_raises(arch):
    for fn in (get_config, get_smoke_config):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("kw", [
    dict(family="moe", n_experts=4, experts_per_token=2),
    dict(family="moe", n_experts=4, use_mla=True, kv_lora_rank=32),
    dict(family="ssm"), dict(family="hybrid", attn_every=2),
    dict(family="vlm"), dict(family="audio", is_encoder_decoder=True)])
def test_unported_family_raises(kw):
    cfg = get_smoke_config(ARCH).replace(**kw)
    for call in (lambda: get_model(cfg),
                 lambda: TT.init(cfg, torch.Generator(), device="cpu"),
                 lambda: TT.init_cache(cfg, 1, 4, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
