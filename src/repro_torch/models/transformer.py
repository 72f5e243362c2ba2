"""The LM for the dense decoder family: the port of the dense paths of
``repro.models.transformer`` (parameter init, the prefill forward, the
KV cache and the single-token decode step).

API (see registry.py):
  init(cfg, generator, device=None)             -> params
  prefill(params, cfg, inputs)                  -> last-token logits
  init_cache(cfg, batch, max_len, device=None)  -> cache
  decode_step(params, cfg, inputs, cache, pos)  -> (logits, cache)

Parameters keep the reference's tree: layer leaves stacked on a leading
``n_layers`` axis, so ``weights.params_from_jax`` carries them across
leaf for leaf. Layers run in a Python loop. ``decode_step`` writes the
new K/V rows into the cache in place and returns the same cache.
Families other than ``dense`` (MoE, MLA, SSM, hybrid, VLM, audio) raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.models import layers as L

# family (or variant) -> the ROADMAP item (queue 1) that ports it
_UNPORTED = {
    "moe": "item 16.2 (MoE)",
    "mla": "item 16.3 (MLA)",
    "ssm": "item 16.4 (SSM)",
    "hybrid": "item 16.5 (hybrid)",
    "vlm": "item 16.6 (VLM)",
    "audio": "item 16.7 (audio)",
}


def require_ported(cfg) -> None:
    """Raise unless ``cfg`` is a dense decoder the port serves."""
    kind = ("mla" if cfg.use_mla else "moe" if cfg.is_moe else cfg.family)
    if kind in _UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {kind} family is not ported to repro_torch "
            f"yet: ROADMAP queue 1, {_UNPORTED[kind]}")
    if kind != "dense":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not an LM "
                         f"(the paper nets live in models/paper_nets.py)")


def _layer(tree: dict, i: int) -> dict:
    """Layer i's parameters: index every stacked leaf."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _block_params(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    """One decoder block, or ``lead`` of them stacked."""
    dev = gen.device
    return {"ln1": L.norm_params(cfg, lead, dev),
            "ln2": L.norm_params(cfg, lead, dev),
            "attn": L.attention_params(gen, cfg, lead),
            "mlp": L.mlp_params(gen, cfg, lead)}


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current card's index, so that devices compare."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def init(cfg, generator: torch.Generator, device=None) -> dict:
    """Random parameters drawn from ``generator`` on ``device`` (None means
    the card); the generator must live on that device."""
    require_ported(cfg)
    dev = _indexed(resolve(device))
    if _indexed(generator.device) != dev:
        raise ValueError(f"init: the generator is on {generator.device}, "
                         f"the parameters are asked for on {dev}")
    dtype = L.dtype_of(cfg)
    params = {
        "embed": {"w": L.embed_init(generator, cfg.padded_vocab,
                                    cfg.d_model, dtype)},
        "norm_f": L.norm_params(cfg, device=generator.device),
        "layers": _block_params(generator, cfg, (cfg.n_layers,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": L.dense_init(generator, cfg.d_model,
                                               cfg.padded_vocab, dtype)}
    return params


# ---------------------------------------------------------------------------
# sequence path (prefill)
# ---------------------------------------------------------------------------


def _attn_seq(p, cfg, x, positions):
    B, S, _ = x.shape
    q, k, v = L.qkv(p, cfg, x)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    o = L.flash_attention(q, k, v, window=cfg.sliding_window)
    return o.reshape(B, S, cfg.n_heads * cfg.head_dim_) @ p["wo"]


def _dense_block_seq(p, cfg, x, positions):
    h = L.apply_norm(p["ln1"], cfg, x)
    x = x + _attn_seq(p["attn"], cfg, h, positions)
    h = L.apply_norm(p["ln2"], cfg, x)
    return x + L.apply_mlp(p["mlp"], cfg, h)


def _backbone(params, cfg, x, positions):
    """The dense decoder stack over x: (B, S, d)."""
    for i in range(cfg.n_layers):
        x = _dense_block_seq(_layer(params["layers"], i), cfg, x, positions)
    return x


def _unembed_w(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"]["w"].T          # (d, Vp)
    return params["lm_head"]["w"]


def _logits(params, cfg, h):
    """(B, d) final hidden states -> (B, Vp) float32 logits."""
    return h.to(torch.float32) @ _unembed_w(params, cfg).to(torch.float32)


def prefill(params, cfg, inputs) -> torch.Tensor:
    """Forward pass over ``inputs["tokens"]`` (B, S); returns the last
    token's logits (B, Vp) in float32."""
    require_ported(cfg)
    tokens = inputs["tokens"].to(torch.int64)
    x = params["embed"]["w"][tokens]
    h = _backbone(params, cfg, x, torch.arange(x.shape[1], device=x.device))
    h = L.apply_norm(params["norm_f"], cfg, h)
    return _logits(params, cfg, h[:, -1])


# ---------------------------------------------------------------------------
# decode (single token with a KV cache)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Zero K and V caches (n_layers, batch, S, G, head_dim) in the model
    dtype on ``device`` (None means the card); S = min(max_len, window)
    under a sliding window, else max_len."""
    require_ported(cfg)
    dev = resolve(device)
    S = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim_)
    dtype = L.dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _attn_decode(p, cfg, x, k_cache, v_cache, pos: int, cache_len: int):
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
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    o = L.decode_attention(q[:, 0], k_cache, v_cache, cache_len)
    return o.reshape(B, 1, cfg.n_heads * cfg.head_dim_) @ p["wo"]


def decode_step(params, cfg, inputs, cache, pos: int):
    """One decode step. inputs: {"token": (B,) int}; pos: the host int
    position of this token. Returns ((B, Vp) float32 logits, cache), the
    cache updated in place."""
    require_ported(cfg)
    x = params["embed"]["w"][inputs["token"].to(torch.int64)][:, None, :]
    S_cache = cache["k"].shape[2]
    cache_len = min(pos + 1, S_cache)          # a host int: no device sync
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        a = L.apply_norm(p["ln1"], cfg, x)
        x = x + _attn_decode(p["attn"], cfg, a, cache["k"][i],
                             cache["v"][i], pos, cache_len)
        a = L.apply_norm(p["ln2"], cfg, x)
        x = x + L.apply_mlp(p["mlp"], cfg, a)
    x = L.apply_norm(params["norm_f"], cfg, x)
    return _logits(params, cfg, x[:, 0]), cache
