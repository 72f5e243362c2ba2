"""The LM zoo: the port of every family of ``repro.models.transformer``
(parameter init, the training loss with its chunked cross entropy and
MoE's load-balance term, the prefill forward, the KV, latent or state
cache and the single-token decode step). A dense or MoE block's
attention is GQA (``layers``) or MLA (``mla``, under ``cfg.use_mla``),
and its FFN an MLP or a mixture of experts (``moe``, under
``cfg.is_moe``). An SSM block is a Mamba2 mixer (``ssm``); the hybrid
family (Zamba2) runs ``attn_every`` of them, then one attention block
whose weights every group shares. The VLM family (Pixtral) is the dense
stack fed embeddings (``embeds`` (B, S, d), a decode step's ``embed``
(B, d)) where the others take tokens: its vision encoder is a stub in
the reference too. The audio family (Whisper) is an encoder-decoder:
the encoder over frame embeddings (B, S_enc, d) with sinusoid positions
and non-causal self attention, the decoder over at most
``max_target_len`` tokens with learned positions, causal self attention
and cross attention to the encoder's output; its conv frontend is a
stub in the reference too.

API (see registry.py):
  init(cfg, generator, device=None)             -> params
  loss_fn(params, cfg, batch)                   -> (loss, aux)
  prefill(params, cfg, inputs)                  -> last-token logits
  init_cache(cfg, batch, max_len, device=None)  -> cache
  decode_step(params, cfg, inputs, cache, pos)  -> (logits, cache)

Parameters keep the reference's tree: layer leaves stacked on a leading
``n_layers`` axis, so ``weights.params_from_jax`` carries them across
leaf for leaf (the hybrid's ``shared`` block unstacked). Layers run in
a Python loop. The loss's gradient is plain autograd, as the reference's
is plain autodiff (nothing in its ``models/`` has a custom VJP).
``decode_step`` writes the new K/V (or latent) rows and the SSM states
into the cache in place and returns the same cache. The audio decode
step reads its cross K/V caches and never writes them, as the
reference's: nothing in either package fills them from the encoder.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.dist import regions as RG
from repro_torch.dist import sharding as SH
from repro_torch.dist.sharding import constraint
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

_LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def require_lm(cfg) -> None:
    """Raise unless ``cfg`` is one of the zoo's LM families (the hybrid
    one in whole groups)."""
    kind = cfg.family
    if kind not in _LM_FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not an LM "
                         f"(the paper nets live in models/paper_nets.py)")
    if kind == "hybrid" and (cfg.attn_every < 1
                             or cfg.n_layers % cfg.attn_every):
        raise ValueError(f"{cfg.name}: the hybrid stack needs whole groups "
                         f"of attn_every={cfg.attn_every} layers, got "
                         f"n_layers={cfg.n_layers}")


def _layers(tree: dict) -> list[dict]:
    """Each layer's parameters: every stacked leaf unbound once, so that
    the backward writes each layer's slice of a leaf's gradient once (one
    stack), where indexing a layer at a time writes a zero stack of the
    whole leaf for each layer."""
    cols = {k: _layers(v) if isinstance(v, dict) else
            RG.unbind(v) if SH.is_dtensor(v) else v.unbind(0)
            for k, v in tree.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _block_params(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    """One decoder block, or ``lead`` of them stacked."""
    dev = gen.device
    p = {"ln1": L.norm_params(cfg, lead, dev),
         "ln2": L.norm_params(cfg, lead, dev),
         "attn": (MLA.mla_params(gen, cfg, lead) if cfg.use_mla
                  else L.attention_params(gen, cfg, lead))}
    if cfg.is_moe:
        p["moe"] = MOE.moe_params(gen, cfg, lead)
    else:
        p["mlp"] = L.mlp_params(gen, cfg, lead)
    return p


def _ssm_block_params(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    return {"ln": L.norm_params(cfg, lead, gen.device),
            "ssm": SSM.ssm_params(gen, cfg, lead)}


def _enc_block_params(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    dev = gen.device
    return {"ln1": L.norm_params(cfg, lead, dev),
            "attn": L.attention_params(gen, cfg, lead),
            "ln2": L.norm_params(cfg, lead, dev),
            "mlp": L.mlp_params(gen, cfg, lead)}


def _dec_block_params(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    dev = gen.device
    return {"ln1": L.norm_params(cfg, lead, dev),
            "self_attn": L.attention_params(gen, cfg, lead),
            "ln2": L.norm_params(cfg, lead, dev),
            "cross_attn": L.attention_params(gen, cfg, lead),
            "ln3": L.norm_params(cfg, lead, dev),
            "mlp": L.mlp_params(gen, cfg, lead)}


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current card's index, so that devices compare."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def init(cfg, generator: torch.Generator, device=None) -> dict:
    """Random parameters drawn from ``generator`` on ``device`` (None means
    the card); the generator must live on that device."""
    require_lm(cfg)
    dev = _indexed(resolve(device))
    if _indexed(generator.device) != dev:
        raise ValueError(f"init: the generator is on {generator.device}, "
                         f"the parameters are asked for on {dev}")
    dtype = L.dtype_of(cfg)
    lead = (cfg.n_layers,)
    params = {
        "embed": {"w": L.embed_init(generator, cfg.padded_vocab,
                                    cfg.d_model, dtype)},
        "norm_f": L.norm_params(cfg, device=generator.device),
    }
    if cfg.family in ("ssm", "hybrid"):
        params["layers"] = _ssm_block_params(generator, cfg, lead)
    elif cfg.family == "audio":
        params["enc_layers"] = _enc_block_params(generator, cfg,
                                                 (cfg.encoder_layers,))
        params["layers"] = _dec_block_params(generator, cfg, lead)
        params["enc_norm"] = L.norm_params(cfg, device=generator.device)
        params["dec_pos"] = {"w": (torch.randn(
            (cfg.max_target_len, cfg.d_model), generator=generator,
            device=generator.device) * 0.02).to(dtype)}
    else:
        params["layers"] = _block_params(generator, cfg, lead)
    if cfg.family == "hybrid":
        params["shared"] = _block_params(generator, cfg.replace(n_experts=0))
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": L.dense_init(generator, cfg.d_model,
                                               cfg.padded_vocab, dtype)}
    return params


# ---------------------------------------------------------------------------
# sequence path (prefill)
# ---------------------------------------------------------------------------


def _attn_seq(p, cfg, x, positions, causal: bool = True):
    """Self attention over x (B, S, d), RoPE at ``positions``, in the
    encoder's self attention too (on top of its sinusoid), as the
    reference applies it."""
    if cfg.use_mla:
        return MLA.mla_prefill(p, cfg, x, positions)[0]
    B, S, _ = x.shape
    q, k, v = L.qkv(p, cfg, x)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if _seq_parallel_attn(cfg):
        # heads do not divide the model axis: sequence-parallel attention
        q = constraint(q, ("batch", "seq_model", None, None))
        k = constraint(k, ("batch", None, None, None))
        v = constraint(v, ("batch", None, None, None))
    o = L.flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return o.reshape(B, S, cfg.n_heads * cfg.head_dim_) @ p["wo"]


def _seq_parallel_attn(cfg) -> bool:
    """Sequence-parallel attention: asked for by the config, under a mesh
    whose model axis the head count does not divide."""
    if not cfg.seq_parallel_attn:
        return False
    mesh = SH.active_mesh()
    if mesh is None or cfg.n_heads == 0:
        return False
    nm = mesh.shape.get("model", 1)
    return nm > 1 and cfg.n_heads % nm != 0


def _dense_block_seq(p, cfg, x, positions):
    """One block -> (x, aux): MoE's aux, or {} after an MLP."""
    h = L.apply_norm(p["ln1"], cfg, x)
    x = x + _attn_seq(p["attn"], cfg, h, positions)
    x = constraint(x, ("batch", "seq", "embed"))
    h = L.apply_norm(p["ln2"], cfg, x)
    if cfg.is_moe:
        y, aux = MOE.apply_moe(p["moe"], cfg, h)
        return x + y, aux
    return x + L.apply_mlp(p["mlp"], cfg, h), {}


def _ssm_block_seq(p, cfg, x):
    h = L.apply_norm(p["ln"], cfg, x)
    return x + SSM.apply_ssm(p["ssm"], cfg, h)


def _ssm_layer_seq(p, cfg, x):
    """One layer of the SSM stack, its saved input sequence-sharded over
    the model axis under a mesh, as the reference's scan body."""
    return _ssm_block_seq(p, cfg, constraint(x, ("batch", "seq_model",
                                                 "embed")))


def _hybrid_group_seq(group, shared, cfg, x, positions):
    """One group of the hybrid stack: its ``attn_every`` SSM layers (the
    list ``group``), then the shared attention block."""
    x = constraint(x, ("batch", "seq_model", "embed"))
    for p in group:
        x = _ssm_block_seq(p, cfg, x)
    return _dense_block_seq(shared, cfg, x, positions)[0]


def _remat(fn, cfg, *args):
    """fn(*args), its activations recomputed in the backward pass under
    ``cfg.remat`` while autograd records."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(RG.preserve(fn), *args, use_reentrant=False)
    return fn(*args)


def _backbone(params, cfg, x, positions):
    """The decoder stack over x: (B, S, d) -> (hidden, aux): ``lb_loss``
    summed over the layers and divided by their count, ``drop_frac`` their
    mean under MoE (else 0), as the reference's scan carries them. Under
    ``cfg.remat`` each layer's activations (its aux with them) are
    recomputed in the backward pass (``torch.utils.checkpoint``), which
    changes memory and never values. PyTorch has no policy that keeps the
    matmuls' outputs, so the reference's ``remat_policy='save_dots'``
    recomputes the whole layer too, as ``'full'`` does. The SSM family
    checkpoints a layer, the hybrid one a group (``attn_every`` SSM
    layers and the shared block), as the reference's scans do."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    no_aux = {"lb_loss": zero, "drop_frac": zero}
    layers = _layers(params["layers"])
    if cfg.family == "ssm":
        for p in layers:
            x = _remat(_ssm_layer_seq, cfg, p, cfg, x)
        return x, no_aux
    if cfg.family == "hybrid":
        G = cfg.attn_every
        for g in range(cfg.n_layers // G):
            x = _remat(_hybrid_group_seq, cfg, layers[g * G:(g + 1) * G],
                       params["shared"], cfg, x, positions)
        return x, no_aux
    auxes = []
    for p in layers:
        x, aux = _remat(_dense_block_seq, cfg, p, cfg, x, positions)
        auxes.append(aux)
    if not cfg.is_moe:
        return x, no_aux
    lb = sum(a["lb_loss"] for a in auxes)     # in layer order, as the scan
    drop = torch.stack([a["drop_frac"] for a in auxes]).mean()
    return x, {"lb_loss": lb / cfg.n_layers, "drop_frac": drop}


def _sinusoid(S: int, d: int, device=None) -> torch.Tensor:
    """(S, d) float32 positions: sin of pos / 10000^(2i/d) in the first
    d/2 columns, cos in the rest."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block_seq(p, cfg, x, positions):
    h = L.apply_norm(p["ln1"], cfg, x)
    x = x + _attn_seq(p["attn"], cfg, h, positions, causal=False)
    h = L.apply_norm(p["ln2"], cfg, x)
    return x + L.apply_mlp(p["mlp"], cfg, h)


def _encoder(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """The Whisper encoder over stub frame embeddings (B, S_enc, d), a
    checkpoint a layer under ``cfg.remat``; returns the normed output."""
    _, S, d = frames.shape
    x = frames + _sinusoid(S, d, frames.device).to(frames.dtype)[None]
    positions = torch.arange(S, device=frames.device)
    for p in _layers(params["enc_layers"]):
        x = _remat(_enc_block_seq, cfg, p, cfg, x, positions)
    return L.apply_norm(params["enc_norm"], cfg, x)


def _cross_attn_seq(p, cfg, x, enc):
    """Attention of x (B, S, d) to the encoder's output (B, S_enc, d): no
    RoPE, no bias, no mask."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = SH.split_heads(x @ p["wq"], (B, S, cfg.n_heads, hd))
    k = SH.split_heads(enc @ p["wk"], (B, enc.shape[1], cfg.n_kv_heads, hd))
    v = SH.split_heads(enc @ p["wv"], (B, enc.shape[1], cfg.n_kv_heads, hd))
    o = L.flash_attention(q, k, v, causal=False)
    return o.reshape(B, S, cfg.n_heads * hd) @ p["wo"]


def _dec_block_seq(p, cfg, x, positions, enc):
    h = L.apply_norm(p["ln1"], cfg, x)
    x = x + _attn_seq(p["self_attn"], cfg, h, positions)
    h = L.apply_norm(p["ln2"], cfg, x)
    x = x + _cross_attn_seq(p["cross_attn"], cfg, h, enc)
    h = L.apply_norm(p["ln3"], cfg, x)
    return x + L.apply_mlp(p["mlp"], cfg, h)


def _decoder_encdec(params, cfg, tokens: torch.Tensor, enc: torch.Tensor):
    """The Whisper decoder over tokens (B, S <= max_target_len), learned
    positions, a checkpoint a layer under ``cfg.remat``; returns the
    hidden states after ``norm_f``."""
    S = tokens.shape[1]
    x = _lookup(params["embed"]["w"], tokens) \
        + params["dec_pos"]["w"][None, :S]
    positions = torch.arange(S, device=x.device)
    for p in _layers(params["layers"]):
        x = _remat(_dec_block_seq, cfg, p, cfg, x, positions, enc)
    return L.apply_norm(params["norm_f"], cfg, x)


def _unembed_w(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"]["w"].T          # (d, Vp)
    return params["lm_head"]["w"]


def chunked_xent(x: torch.Tensor, w_unembed: torch.Tensor,
                 labels: torch.Tensor, vocab_size: int,
                 chunk: int = 256, *, remat: bool = False) -> torch.Tensor:
    """Mean cross entropy over B * S without the (B, S, Vp) logits at
    once: the sequence in chunks of ``chunk`` positions (the last padded,
    its rows weighted 0), each chunk's logits in float32 from the inputs
    as stored, the padded vocabulary (``w_unembed`` (d, Vp), Vp >=
    ``vocab_size``) masked to -1e30, the gold logit by ``gather``. With
    ``remat`` while autograd records, each chunk's logits are recomputed
    in the backward pass (``torch.utils.checkpoint``), so that one
    chunk's, not every chunk's, are kept; values are unchanged.
    x: (B, S, d); labels: (B, S) ints below ``vocab_size``."""
    B, S, d = x.shape
    Vp = w_unembed.shape[1]
    x = constraint(x, ("batch", "seq", "embed"))
    labels = constraint(labels, ("batch", "seq"))
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        pad_fn = RG.pad if SH.is_dtensor(x) else torch.nn.functional.pad
        x = pad_fn(x, (0, 0, 0, pad))
        labels = pad_fn(labels, (0, pad))
    labels = labels.to(torch.int64)
    dev = x.device
    vmask = torch.arange(Vp, device=dev) < vocab_size
    valid = (torch.arange(S + pad, device=dev) < S).to(torch.float32)
    w = w_unembed.to(torch.float32)

    def part(xc, w, lc, vc):
        logits = xc.to(torch.float32) @ w                    # (B, c, Vp)
        logits = torch.where(vmask, logits, -1e30)
        if SH.is_dtensor(logits):
            lse, gold = RG.xent(logits, lc)
        else:
            # gold first, as ``regions.xent``: the backward runs the later
            # op's first, so logsumexp's (B, c, Vp) temporaries are freed
            # before the gather's (B, c, Vp) gradient is made
            gold = logits.gather(-1, lc[..., None])[..., 0]
            lse = torch.logsumexp(logits, dim=-1)
        return ((lse - gold) * vc).sum()

    if remat and torch.is_grad_enabled():
        part = functools.partial(checkpoint, RG.preserve(part),
                                 use_reentrant=False)
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    for c0 in range(0, S + pad, chunk):
        tot = tot + part(x[:, c0:c0 + chunk], w, labels[:, c0:c0 + chunk],
                         valid[c0:c0 + chunk])
    return tot / (B * S)


def _lookup(w, ids):
    """Rows of the embedding table ``w`` at integer ``ids``; on DTensors
    each vocabulary shard's own rows (``dist.regions.embed``)."""
    if SH.is_dtensor(w):
        return RG.embed(w, ids)
    return w[ids.to(torch.int64)]


def _embed_in(params, cfg, batch) -> torch.Tensor:
    """The stack's input (B, S, d): the VLM's ``embeds`` as handed in,
    else the embedding of ``tokens``."""
    if cfg.family == "vlm":
        return batch["embeds"]
    return _lookup(params["embed"]["w"], batch["tokens"])


def loss_fn(params, cfg, batch) -> tuple[torch.Tensor, dict]:
    """batch: {"tokens", "labels"} (B, S) ints; the VLM's {"embeds" (B, S,
    d), "labels"}; audio's {"frames" (B, S_enc, d), "tokens", "labels"
    (B, S_dec)} -> (mean next-token cross entropy, plus 0.01 * lb_loss
    under MoE; aux). aux holds the reference's MoE terms (``_backbone``),
    zero for an MLP model; audio's is {"lb_loss": 0}, as the
    reference's. Under ``cfg.remat`` the cross entropy's chunks are
    recomputed in the backward pass too (``chunked_xent``)."""
    require_lm(cfg)
    if cfg.family == "audio":
        enc = _encoder(params, cfg, batch["frames"])
        h = _decoder_encdec(params, cfg, batch["tokens"], enc)
        loss = chunked_xent(h, _unembed_w(params, cfg), batch["labels"],
                            cfg.vocab_size, remat=cfg.remat)
        return loss, {"lb_loss": torch.zeros((), dtype=torch.float32,
                                             device=h.device)}
    x = constraint(_embed_in(params, cfg, batch), ("batch", "seq", "embed"))
    h, aux = _backbone(params, cfg, x,
                       torch.arange(x.shape[1], device=x.device))
    h = L.apply_norm(params["norm_f"], cfg, h)
    loss = chunked_xent(h, _unembed_w(params, cfg), batch["labels"],
                        cfg.vocab_size, remat=cfg.remat)
    if cfg.is_moe:
        loss = loss + 0.01 * aux["lb_loss"]
    return loss, aux


def _logits(params, cfg, h):
    """(B, d) final hidden states -> (B, Vp) float32 logits."""
    return h.to(torch.float32) @ _unembed_w(params, cfg).to(torch.float32)


def prefill(params, cfg, inputs) -> torch.Tensor:
    """Forward pass over ``inputs["tokens"]`` (B, S) (the VLM's
    ``embeds``; audio's ``frames`` and decoder ``tokens``); returns the
    last position's logits (B, Vp) in float32."""
    require_lm(cfg)
    if cfg.family == "audio":
        enc = _encoder(params, cfg, inputs["frames"])
        h = _decoder_encdec(params, cfg, inputs["tokens"], enc)
    else:
        x = constraint(_embed_in(params, cfg, inputs),
                       ("batch", "seq_model", "embed"))
        h, _ = _backbone(params, cfg, x,
                         torch.arange(x.shape[1], device=x.device))
        h = L.apply_norm(params["norm_f"], cfg, h)
    return _logits(params, cfg, h[:, -1])


# ---------------------------------------------------------------------------
# decode (single token with a KV cache)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Zero K and V caches (n_layers, batch, S, G, head_dim) in the model
    dtype on ``device`` (None means the card); S = min(max_len, window)
    under a sliding window, else max_len. Under MLA the latent caches
    instead: c_kv (n_layers, batch, max_len, kv_lora_rank) and k_rope
    (n_layers, batch, max_len, 64). The SSM family's: conv (n_layers,
    batch, K-1, d_inner + 2 n) in the model dtype and state (n_layers,
    batch, nh, hp, n) in float32; the hybrid's those and K/V for each
    application of the shared block, (n_layers / attn_every, batch, S, G,
    head_dim). Audio's: self K/V (n_layers, batch, max_target_len, G,
    head_dim), whatever max_len, and cross K/V (n_layers, batch, max_len
    // frontend_downsample, G, head_dim), max_len counting input frames
    as the reference's does."""
    require_lm(cfg)
    dev = resolve(device)
    dtype = L.dtype_of(cfg)
    S = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    cache = {}
    if cfg.family == "audio":
        kv = (cfg.n_kv_heads, cfg.head_dim_)
        shapes = {"k": cfg.max_target_len, "v": cfg.max_target_len,
                  "cross_k": max_len // cfg.frontend_downsample,
                  "cross_v": max_len // cfg.frontend_downsample}
        return {name: torch.zeros((cfg.n_layers, batch, n, *kv), dtype=dtype,
                                  device=dev) for name, n in shapes.items()}
    if cfg.family in ("ssm", "hybrid"):
        cache = {
            "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state),
                                dtype=dtype, device=dev),
            "state": torch.zeros((cfg.n_layers, batch, cfg.ssm_nheads,
                                  cfg.ssm_headdim, cfg.ssm_state),
                                 dtype=torch.float32, device=dev)}
        if cfg.family == "ssm":
            return cache
    if cfg.use_mla:
        lead = (cfg.n_layers, batch, max_len)
        return {"c_kv": torch.zeros((*lead, cfg.kv_lora_rank), dtype=dtype,
                                    device=dev),
                "k_rope": torch.zeros((*lead, MLA.ROPE_DIM), dtype=dtype,
                                      device=dev)}
    n_apps = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
              else cfg.n_layers)
    shape = (n_apps, batch, S, cfg.n_kv_heads, cfg.head_dim_)
    return {**cache, "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _attn_decode(p, cfg, x, k_cache, v_cache, pos: int):
    """x: (B,1,d). Writes this token's K/V into the (B, S, G, hd) caches
    in place, at slot pos % S under a sliding window (a ring buffer),
    else at pos (clamped to the last slot, as the reference's
    dynamic_update_slice clamps), then attends over the cache."""
    B = x.shape[0]
    S_cache = k_cache.shape[1]
    q, k, v = L.qkv(p, cfg, x)
    posv = torch.full((B, 1), pos, device=x.device)
    q = L.rope(q, posv, cfg.rope_theta)
    k = L.rope(k, posv, cfg.rope_theta)
    slot = pos % S_cache if cfg.sliding_window else min(pos, S_cache - 1)
    cache_len = min(pos + 1, S_cache)          # a host int: no device sync
    L.write_slot(k_cache, slot, k[:, 0])
    L.write_slot(v_cache, slot, v[:, 0])
    o = L.decode_attention(q[:, 0], k_cache, v_cache, cache_len)
    return o.reshape(B, 1, cfg.n_heads * cfg.head_dim_) @ p["wo"]


def decode_step(params, cfg, inputs, cache, pos: int):
    """One decode step. inputs: {"token": (B,) int} or, in any family,
    {"embed": (B, d)}, which is taken where present; pos: the host int
    position of this token. Returns ((B, Vp) float32 logits, cache), the
    cache updated in place."""
    require_lm(cfg)
    if "embed" in inputs:
        x = inputs["embed"][:, None, :]
    else:
        x = _lookup(params["embed"]["w"], inputs["token"])[:, None, :]
    if cfg.family in ("ssm", "hybrid", "audio"):
        decode = _audio_decode if cfg.family == "audio" else _ssm_decode
        x = decode(params, cfg, x, cache, pos)
        x = L.apply_norm(params["norm_f"], cfg, x)
        return _logits(params, cfg, x[:, 0]), cache
    for i, p in enumerate(_layers(params["layers"])):
        a = L.apply_norm(p["ln1"], cfg, x)
        if cfg.use_mla:
            x = x + MLA.mla_decode(p["attn"], cfg, a, cache["c_kv"][i],
                                   cache["k_rope"][i], pos)
        else:
            x = x + _attn_decode(p["attn"], cfg, a, cache["k"][i],
                                 cache["v"][i], pos)
        a = L.apply_norm(p["ln2"], cfg, x)
        x = x + (MOE.apply_moe(p["moe"], cfg, a)[0] if cfg.is_moe
                 else L.apply_mlp(p["mlp"], cfg, a))
    x = L.apply_norm(params["norm_f"], cfg, x)
    return _logits(params, cfg, x[:, 0]), cache


def _ssm_decode(params, cfg, x, cache, pos: int):
    """The SSM and hybrid stacks' decode: each layer's recurrent update on
    its conv and SSM states; in the hybrid, after every ``attn_every``
    layers the shared block, its attention on that application's K/V
    (a ring at pos % S under the window)."""
    G = cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
    shared = params.get("shared")
    for i, p in enumerate(_layers(params["layers"])):
        a = L.apply_norm(p["ln"], cfg, x)
        x = x + SSM.ssm_decode_step(p["ssm"], cfg, a, cache["conv"][i],
                                    cache["state"][i])
        if shared is not None and (i + 1) % G == 0:
            g = i // G
            a = L.apply_norm(shared["ln1"], cfg, x)
            x = x + _attn_decode(shared["attn"], cfg, a, cache["k"][g],
                                 cache["v"][g], pos)
            a = L.apply_norm(shared["ln2"], cfg, x)
            x = x + L.apply_mlp(shared["mlp"], cfg, a)
    return x


def _audio_decode(params, cfg, x, cache, pos: int):
    """The Whisper decoder's step. Positions past ``max_target_len`` - 1
    clamp to it, as the reference's gathers and slot writes clamp: the
    learned position's row, RoPE, the self K/V slot, and a cache_len of
    at most ``max_target_len``. Cross attention runs through
    ``decode_attention`` over the whole cross cache, read as it stands."""
    last = min(pos, cfg.max_target_len - 1)
    x = x + params["dec_pos"]["w"][last][None, None, :]
    for i, p in enumerate(_layers(params["layers"])):
        a = L.apply_norm(p["ln1"], cfg, x)
        x = x + _attn_decode(p["self_attn"], cfg, a, cache["k"][i],
                             cache["v"][i], last)
        a = L.apply_norm(p["ln2"], cfg, x)
        x = x + _cross_attn_decode(p["cross_attn"], cfg, a,
                                   cache["cross_k"][i], cache["cross_v"][i])
        a = L.apply_norm(p["ln3"], cfg, x)
        x = x + L.apply_mlp(p["mlp"], cfg, a)
    return x


def _cross_attn_decode(p, cfg, x, k_cache, v_cache):
    """x (B, 1, d) attends to the (B, S_enc, G, hd) cross caches: q with
    no RoPE and no bias, every position valid."""
    B = x.shape[0]
    q = SH.split_heads(x[:, 0] @ p["wq"], (B, cfg.n_heads, cfg.head_dim_))
    o = L.decode_attention(q, k_cache, v_cache, k_cache.shape[1])
    return o.reshape(B, 1, cfg.n_heads * cfg.head_dim_) @ p["wo"]
