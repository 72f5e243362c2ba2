"""The port's audio family and whisper-large-v3 (an encoder-decoder: 32
encoder and 32 decoder layers, 20 heads of 64, a dense tanh-GELU MLP,
LayerNorm, tied embeddings; the conv frontend a stub in the reference
too) against the JAX package, on the CPU, inputs made from a seed with
numpy and both packages started from the reference's parameters.

At the arch's smoke config, in float32 and bfloat16 at
``tests/lm_parity.py``'s tolerances: the init tree; ``_sinusoid`` and
``_encoder``; the loss and every gradient from frames and decoder
tokens; prefill; and ``decode_step`` at every step of a loop that runs
past ``max_target_len`` (32 in the smoke config), where the learned
position's row, RoPE and the self K/V slot clamp to the last, from the
same NONZERO cross caches in both packages. Neither package writes the
cross caches (``init_cache`` zeros them; ROADMAP queue 3, fault 8), and
over zero caches the cross term is 0, so a comparison there would prove
nothing about it. Decode == prefill is the port's own check, in float32,
with the cross caches filled by :func:`fill_cross` (the encoder's
output through each decoder layer's cross ``wk`` / ``wv``, no RoPE, no
bias), which is test code and no part of either package. One
``sync_grads`` call on the bfloat16 smoke tree equals the reference's
synced values, ages and wire bytes exactly.

``_sinusoid`` at the full width's 1,500 encoder positions and d 1,280
agrees to 2.5e-4, two float32 steps of its largest angle (1,499 rad):
the two packages' float32 ``pow`` may part by one rounding, which the
angle carries into sin and cos; at the smoke width to 1e-6.
whisper's decode shapes (rep 1, D 64, over 448 self and 1,500 cross
positions) run through ``tests/test_torch_decode_attention.py``'s sweep.
"""
import dataclasses

import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke_config
from repro.models import transformer as JT

import lm_parity as P
from repro_torch import tree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve, train
from repro_torch.models import transformer as TT

ARCH = "whisper-large-v3"
R, K = 512, 64                  # the sync's budget on the smoke tree
S_ENC = 24                      # the decode loop's cross-cache positions
STEPS = 36                      # past the smoke config's max_target_len


def fill_cross(params, cfg, frames, cache):
    """Write the encoder's output over ``frames`` (B, S_enc, d) through
    each decoder layer's cross ``wk`` / ``wv`` into the cross caches, (B,
    S_enc, G, D) a layer, no RoPE, as ``_cross_attn_seq`` projects it."""
    B, S = frames.shape[:2]
    with torch.no_grad():
        enc = TT._encoder(params, cfg, frames)
        for i in range(cfg.n_layers):
            p = params["layers"]["cross_attn"]
            for name, w in (("cross_k", "wk"), ("cross_v", "wv")):
                cache[name][i] = (enc @ p[w][i]).reshape(
                    B, S, cfg.n_kv_heads, cfg.head_dim_)
    return cache


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def ref(request):
    """lm_parity's runs, and the reference's decode loop of ``STEPS``
    tokens from nonzero cross caches."""
    ref = P.reference(ARCH, request.param)
    jcfg = ref["jcfg"]
    rng = np.random.default_rng(5)
    cache0 = {k: np.zeros(v.shape, np.float32) for k, v in
              JT.init_cache(jcfg, P.B, 2 * S_ENC).items()}
    for name in ("cross_k", "cross_v"):
        cache0[name] = rng.standard_normal(cache0[name].shape).astype(
            np.float32)
    feeds = [{"token": P.tokens((P.B,), 30 + t)} for t in range(STEPS)]
    ref["cross_run"] = dict(cache0=cache0, feeds=feeds, steps=P.jax_feed(
        jcfg, ref["jparams"], feeds, P.to_j(cache0, jcfg.dtype)))
    return ref


def test_params_carry_across_leaf_for_leaf(ref):
    """The encoder and decoder stacks on their leading layer axes, the
    encoder's norm and the decoder's learned positions."""
    P.check_init_tree(ref)
    cfg, params = ref["tcfg"], ref["tparams"]
    assert set(params) == {"dec_pos", "embed", "enc_layers", "enc_norm",
                           "layers", "norm_f"}
    assert params["enc_layers"]["attn"]["wq"].shape[0] == cfg.encoder_layers
    assert set(params["layers"]) == {"cross_attn", "ln1", "ln2", "ln3", "mlp",
                                     "self_attn"}
    assert tuple(params["dec_pos"]["w"].shape) == (cfg.max_target_len,
                                                   cfg.d_model)


@pytest.mark.parametrize("S,d,tol", [(S_ENC, 128, 1e-6),
                                     (1500, 1280, 2.5e-4)])
def test_sinusoid_matches_jax(S, d, tol):
    got = TT._sinusoid(S, d)
    assert got.dtype == torch.float32 and got.shape == (S, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(JT._sinusoid(S, d)),
                               rtol=0, atol=tol)


def test_encoder_matches_jax(ref):
    """The encoder's normed output over the loss batch's frames."""
    frames = ref["batch_np"]["frames"]
    want = JT._encoder(ref["jparams"], ref["jcfg"],
                       P.to_j({"f": frames}, ref["dtype"])["f"])
    got = TT._encoder(ref["tparams"], ref["tcfg"],
                      P.to_t({"f": frames}, ref["dtype"])["f"])
    assert got.dtype == getattr(torch, ref["dtype"])
    P.close(got, want, ref["tol"]["cache"])


def test_loss_fn_matches(ref):
    assert set(ref["batch"]) == {"frames", "tokens", "labels"}
    assert ref["batch"]["tokens"].shape == (P.B, ref["tcfg"].max_target_len)
    assert set(ref["aux"]) == {"lb_loss"}
    P.check_loss(ref)


def test_prefill_matches_jax(ref):
    P.check_prefill(ref)


def test_decode_from_cross_caches_matches_jax(ref):
    """``STEPS`` decode steps from the same nonzero cross caches (the
    reference's cache tree carried across by ``weights.params_from_jax``):
    logits and every cache (the cross ones unchanged) at every step, past
    the self cache's ``max_target_len`` positions."""
    run = ref["cross_run"]
    assert STEPS > ref["tcfg"].max_target_len
    cache = P.carry(P.to_j(run["cache0"], ref["dtype"]))
    cross = cache["cross_k"].clone()
    P.check_feed_loop(ref, run["feeds"], run["steps"], cache)
    assert torch.equal(cache["cross_k"], cross)


def test_decode_matches_own_prefill():
    """float32, port only: decode steps over the prefill's decoder tokens,
    from cross caches filled from the same frames, end at the prefill's
    last logits within 1e-4."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32", remat=False)
    params = TT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    inputs = P.to_t(P.model_inputs(cfg, 2, 10, 8, s_dec=12), "float32")
    full = TT.prefill(params, cfg, inputs)
    cache = fill_cross(params, cfg, inputs["frames"],
                       TT.init_cache(cfg, 2, 20, device="cpu"))
    for t in range(12):
        logits, cache = TT.decode_step(
            params, cfg, {"token": inputs["tokens"][:, t]}, cache, t)
    P.close_logits(logits, full, 1e-4)
    empty = TT.decode_step(params, cfg, {"token": inputs["tokens"][:, 0]},
                           TT.init_cache(cfg, 2, 20, device="cpu"), 0)[0]
    assert not torch.allclose(empty, TT.decode_step(
        params, cfg, {"token": inputs["tokens"][:, 0]},
        fill_cross(params, cfg, inputs["frames"],
                   TT.init_cache(cfg, 2, 20, device="cpu")), 0)[0])


def test_remat_is_bitwise():
    """``cfg.remat`` recomputes each encoder and decoder layer in the
    backward pass: no bit of the loss or a gradient changes."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32", remat=False)
    params = TT.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    batch = P.to_t(P.model_inputs(cfg, 2, 16, 2, train=True, s_dec=20),
                   "float32")
    outs = [tree.value_and_grad(
        lambda p, b: TT.loss_fn(p, cfg.replace(remat=remat), b)[0], params,
        batch) for remat in (False, True)]
    (l0, g0), (l1, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g0),
                                                 tree.leaves(g1)))


def test_full_width_config_and_cache():
    """whisper-large-v3 at full width: every config field the reference's;
    1,535,057,920 parameters by ``param_count``; 30 s of audio (3,000
    frames) give self caches of 448 positions and cross caches of 1,500;
    the largest stacked leaf below 2^31 elements."""
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(j_smoke_config(ARCH))
    assert cfg.param_count() == 1_535_057_920 and cfg.padded_vocab == 52_224
    cache = TT.init_cache(cfg, 8, 3000, device="meta")
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "k": ((32, 8, 448, 20, 64), torch.bfloat16),
        "v": ((32, 8, 448, 20, 64), torch.bfloat16),
        "cross_k": ((32, 8, 1500, 20, 64), torch.bfloat16),
        "cross_v": ((32, 8, 1500, 20, 64), torch.bfloat16)}
    assert cfg.padded_vocab * cfg.d_model < cfg.n_layers * cfg.d_model \
        * cfg.d_ff < 2 ** 31


def test_sync_grads_on_audio_tree():
    tg = P.check_sync_grads(ARCH, R, K)
    assert len(tree.leaves(tg)) == 32


def test_serve_and_train_clis_refuse_audio(monkeypatch):
    """``launch.serve`` refuses the encoder-decoder with the reference's
    message, ``launch.train`` with fault 9's (ROADMAP queue 3), both
    before they look for a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cpu"]):
        with pytest.raises(SystemExit, match="decoder-only"):
            serve.main(["--arch", ARCH, "--smoke", *extra])
        with pytest.raises(ValueError, match="fault 9"):
            train.main(["--arch", ARCH, "--smoke", *extra])
