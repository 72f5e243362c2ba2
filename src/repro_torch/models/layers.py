"""Shared LM layers: the port of ``repro.models.layers`` (init helpers,
norms, RoPE, activations, MLPs, attention parameters and projections,
the chunked prefill attention and the decode attention).

Plain functions on tensors; parameters are nested dicts of tensors in the
JAX layout (``x @ w`` with ``w`` of shape (d_in, d_out)). Draws take a
``torch.Generator`` and land on its device. The sharding constraints of
the JAX file are not ported: on one card they are the identity.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               lead: tuple = ()) -> torch.Tensor:
    """N(0, 1/d_in) weights of shape (*lead, d_in, d_out): ``lead`` stacks
    one draw per layer, as the reference's vmapped init does."""
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=gen.device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_params(cfg, lead: tuple = (), device=None) -> dict:
    d = cfg.d_model
    p = {"scale": torch.ones((*lead, d), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((*lead, d), device=device)
    return p


def apply_norm(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, in float32, cast back."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotary over D; positions: (S,) or (B, S). Angles
    in float32."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs   # (S|B,S, half)
    ang = ang[None, :, None, :] if positions.ndim == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activation / MLP
# ---------------------------------------------------------------------------


def act_fn(name: str):
    """``jax.nn.gelu`` defaults to the tanh form, so gelu here is too."""
    return {"silu": F.silu, "relu": F.relu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp_params(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dtype = dtype_of(cfg)
    if cfg.mlp_type == "glu":
        return {
            "w1": dense_init(gen, d, f, dtype, lead),   # gate
            "w3": dense_init(gen, d, f, dtype, lead),   # up
            "w2": dense_init(gen, f, d, dtype, lead),   # down
        }
    return {"w1": dense_init(gen, d, f, dtype, lead),
            "w2": dense_init(gen, f, d, dtype, lead)}


def apply_mlp(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    a = act_fn(cfg.act)
    if cfg.mlp_type == "glu":
        h = a(x @ p["w1"]) * (x @ p["w3"])
    else:
        h = a(x @ p["w1"])
    return h @ p["w2"]


# ---------------------------------------------------------------------------
# attention parameters
# ---------------------------------------------------------------------------


def attention_params(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    H, G = cfg.n_heads, cfg.n_kv_heads
    dtype = dtype_of(cfg)
    p = {
        "wq": dense_init(gen, d, H * hd, dtype, lead),
        "wk": dense_init(gen, d, G * hd, dtype, lead),
        "wv": dense_init(gen, d, G * hd, dtype, lead),
        "wo": dense_init(gen, H * hd, d, dtype, lead),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H), ("bk", G), ("bv", G)):
            p[name] = torch.zeros((*lead, width * hd), dtype=dtype,
                                  device=gen.device)
    return p


def qkv(p: dict, cfg, x: torch.Tensor):
    """x: (B,S,d) -> q (B,S,H,hd), k/v (B,S,G,hd)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, cfg.n_heads, hd),
            k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, G, D) -> (B, Sq, H, Dv): attention
    with an online softmax over KV chunks, as the reference computes it
    (inputs of each product rounded to the stored dtype, products summed
    in float32, all -inf rows guarded). Plain PyTorch; the prefill path."""
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = H // G
    kv_chunk = min(kv_chunk, Skv)
    dev = q.device
    qf = (q.to(torch.float32) * D ** -0.5).to(q.dtype).to(torch.float32)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Sq), -math.inf, device=dev)
    l = torch.zeros((B, H, Sq), device=dev)
    for c0 in range(0, Skv, kv_chunk):
        k_pos = c0 + torch.arange(kv_chunk, device=dev)
        ki = k[:, c0:c0 + kv_chunk].repeat_interleave(rep, dim=2)
        vi = v[:, c0:c0 + kv_chunk].repeat_interleave(rep, dim=2)
        n = ki.shape[1]
        k_pos = k_pos[:n]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, ki.to(torch.float32))
        mask = torch.ones((Sq, n), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype).to(torch.float32),
            vi.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                # (B, Sq, H, Dv)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """One query token per head (B, H, D) over the first ``cache_len``
    positions of the (B, S, G, D) cache: the CUDA kernel on the card, its
    plain version on the CPU. Unlike the reference layer it does not round
    q * scale and the softmax weights to the cache dtype: both stay
    float32, as in the TPU kernel."""
    return ops.decode_attention(q, k_cache, v_cache, cache_len)
