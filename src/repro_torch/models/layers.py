"""Shared LM layers: the port of ``repro.models.layers`` (init helpers,
norms, RoPE, activations, MLPs, attention parameters and projections,
the chunked prefill attention and the decode attention).

Plain functions on tensors, differentiable by autograd (none writes in
place into a tensor that autograd keeps; the training loss's gradient
goes through them); parameters are nested dicts of tensors in the JAX
layout (``x @ w`` with ``w`` of shape (d_in, d_out)). Draws take a
``torch.Generator`` and land on its device. The sharding constraints
sit where the JAX file has them (``dist.sharding.constraint``): the
identity without an active mesh and on plain tensors, so one card and
the CPU run exactly what they ran before.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist import regions as RG
from repro_torch.dist.sharding import constraint, is_dtensor, split_heads
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


def mlp_params(gen: torch.Generator, cfg, lead: tuple = (),
               d_ff: int | None = None) -> dict:
    """A GLU (gate w1, up w3, down w2) or plain MLP of width ``d_ff``
    (``cfg.d_ff`` when None or 0, as in the reference)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
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
    h = constraint(h, ("batch", "seq", "d_ff")) if h.ndim == 3 else h
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
    return (split_heads(q, (B, S, cfg.n_heads, hd)),
            split_heads(k, (B, S, cfg.n_kv_heads, hd)),
            split_heads(v, (B, S, cfg.n_kv_heads, hd)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


# The most float32 scores a tile holds, in elements: a call's query block
# is the largest power of two of rows whose (B, H, rows, kv_chunk) scores
# fit, so that one tile, not the whole query length, bounds what is live.
TILE_ELEMS = 1 << 25


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, G, D) -> (B, Sq, H, Dv): attention
    with an online softmax over KV chunks, as the reference computes it
    (q * D^-0.5 and the softmax weights rounded to the stored dtype before
    their products, products summed in float32, all -inf rows guarded).
    Plain PyTorch; the prefill and training path. It works in tiles of
    (query block x KV chunk), skips the tiles that the mask empties, and
    keeps for its backward only q, k, v, the output and each row's
    float32 log-sum-exp: the backward recomputes each tile's weights
    (:class:`_FlashAttention`). On DTensors (the dry run) it runs on each
    device's shards (``dist.regions.flash_attention``)."""
    if is_dtensor(q):
        return RG.flash_attention(flash_attention, q, k, v, causal=causal,
                                  window=window, q_offset=q_offset,
                                  kv_chunk=kv_chunk)
    return _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                 min(kv_chunk, k.shape[1]))


class _FlashAttention(torch.autograd.Function):
    """The flash attention's forward and a backward that recomputes each
    tile's scores and weights from the saved log-sum-exp, then forms
    dS = P * (dP - rowsum(dO * O)). The query heads of a KV head are one
    group of rows (``_rows``), so each product sums over them and no K or
    V is repeated: the sum over a KV head's ``rep`` query heads that
    ``repeat_interleave``'s backward would make. dq, dk and dv accumulate
    in float32 in a fixed loop order."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_chunk):
        out, lse = _flash_forward(q, k, v, causal, window, q_offset,
                                  kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_backward(q, k, v, out, lse, do, *ctx.args),
                None, None, None, None)


def _rows(x: torch.Tensor, q0: int, q1: int, G: int,
          scale: float = 0.0) -> torch.Tensor:
    """Rows q0:q1 of x (B, Sq, H, E) as float32 (B, G, H // G * rows, E):
    query head h reads KV head h // (H // G). With ``scale``, x * scale
    rounded to x's dtype first, as the reference rounds q."""
    B, _, H, E = x.shape
    x = x[:, q0:q1]
    if scale:
        x = (x.to(torch.float32) * scale).to(x.dtype)
    return x.to(torch.float32).transpose(1, 2).reshape(B, G, -1, E)


def _kv(x: torch.Tensor, c0: int, c1: int) -> torch.Tensor:
    """Positions c0:c1 of k or v (B, Skv, G, E) as float32 (B, G, n, E)."""
    return x[:, c0:c1].to(torch.float32).transpose(1, 2)


def _tiles(Sq: int, Skv: int, B: int, H: int, kv_chunk: int, causal: bool,
           window: int, q_offset: int):
    """The query blocks (q0, q1, [(c0, c1, masked), ...]): each block's KV
    chunks that hold a kept pair, in order, ``masked`` where the tile
    drops some pair (:func:`_tile_mask`)."""
    rows = max(1, TILE_ELEMS // (B * H * kv_chunk))
    block = 1 << (rows.bit_length() - 1)
    for q0 in range(0, Sq, block):
        q1 = min(q0 + block, Sq)
        lo, hi = q_offset + q0, q_offset + q1 - 1      # its positions
        chunks = []
        for c0 in range(0, Skv, kv_chunk):
            c1 = min(c0 + kv_chunk, Skv)
            if (causal and c0 > hi) or (window and c1 - 1 <= lo - window):
                continue
            chunks.append((c0, c1, bool((causal and c1 - 1 > lo) or (
                window and c0 <= hi - window))))
        yield q0, q1, chunks


def _tile_mask(q0: int, q1: int, c0: int, c1: int, causal: bool,
               window: int, q_offset: int, dev) -> torch.Tensor:
    """The (q1 - q0, c1 - c0) pairs of a tile that the mask keeps."""
    q_pos = torch.arange(q_offset + q0, q_offset + q1, device=dev)[:, None]
    k_pos = torch.arange(c0, c1, device=dev)[None, :]
    keep = torch.ones((q1 - q0, c1 - c0), dtype=torch.bool, device=dev)
    if causal:
        keep &= k_pos <= q_pos
    if window:
        keep &= k_pos > q_pos - window
    return keep


def _masked(x: torch.Tensor, mask, fill: float, rep: int) -> torch.Tensor:
    """x (B, G, rep * rows, n) with ``fill`` where the tile's mask (rows,
    n, or None where it keeps every pair) drops a pair."""
    if mask is None:
        return x
    B, G, R, n = x.shape
    return torch.where(mask, x.view(B, G, rep, R // rep, n), fill).view(
        B, G, R, n)


def _flash_forward(q, k, v, causal, window, q_offset, kv_chunk):
    """(out (B, Sq, H, Dv) in q's dtype, lse (B, G, rep, Sq) float32):
    each query block's online softmax over its chunks."""
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = H // G
    dev = q.device
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, G, rep, Sq), dtype=torch.float32, device=dev)
    for q0, q1, chunks in _tiles(Sq, Skv, B, H, kv_chunk, causal, window,
                                 q_offset):
        qb = _rows(q, q0, q1, G, D ** -0.5)             # (B, G, R, D)
        R = qb.shape[2]
        acc = torch.zeros((B, G, R, Dv), dtype=torch.float32, device=dev)
        m = torch.full((B, G, R), -math.inf, device=dev)
        l = torch.zeros((B, G, R), device=dev)
        for c0, c1, masked in chunks:
            mask = _tile_mask(q0, q1, c0, c1, causal, window, q_offset,
                              dev) if masked else None
            s = _masked(qb @ _kv(k, c0, c1).transpose(-1, -2), mask,
                        -math.inf, rep)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = _masked(torch.exp(s - m_safe[..., None]), mask, 0.0, rep)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + (
                p.to(v.dtype).to(torch.float32) @ _kv(v, c0, c1))
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out[:, q0:q1] = (acc / l[..., None]).view(B, H, q1 - q0, Dv
                                                  ).transpose(1, 2)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        lse[..., q0:q1] = (m_safe + torch.log(l)).view(B, G, rep, q1 - q0)
    return out, lse


def _flash_backward(q, k, v, out, lse, do, causal, window, q_offset,
                    kv_chunk):
    """(dq, dk, dv) of :func:`_flash_forward` for the output's gradient
    ``do``: each tile's weights P = exp(S - lse) recomputed, dv += P^T dO
    (P rounded to v's dtype, as the forward's product), dS = P * (dO V^T
    - rowsum(dO * O)), dq += dS K, dk += dS^T q."""
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], k.shape[2]
    rep = H // G
    dev = q.device
    dk = torch.zeros((B, G, Skv, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, G, Skv, v.shape[-1]), dtype=torch.float32,
                     device=dev)
    dq = torch.empty_like(q)
    for q0, q1, chunks in _tiles(Sq, Skv, B, H, kv_chunk, causal, window,
                                 q_offset):
        qb = _rows(q, q0, q1, G, D ** -0.5)             # (B, G, R, D)
        dob = _rows(do, q0, q1, G)                       # (B, G, R, Dv)
        delta = (dob * _rows(out, q0, q1, G)).sum(-1)    # (B, G, R)
        lb = lse[..., q0:q1].reshape(B, G, -1)
        dqb = torch.zeros(qb.shape, dtype=torch.float32, device=dev)
        for c0, c1, masked in chunks:
            mask = _tile_mask(q0, q1, c0, c1, causal, window, q_offset,
                              dev) if masked else None
            kc, vc = _kv(k, c0, c1), _kv(v, c0, c1)
            p = _masked(torch.exp(qb @ kc.transpose(-1, -2) - lb[..., None]),
                        mask, 0.0, rep)
            dv[:, :, c0:c1] += p.to(v.dtype).to(torch.float32).transpose(
                -1, -2) @ dob
            ds = p * (dob @ vc.transpose(-1, -2) - delta[..., None])
            dqb += ds @ kc
            dk[:, :, c0:c1] += ds.transpose(-1, -2) @ qb
        dq[:, q0:q1] = (dqb * D ** -0.5).view(B, H, q1 - q0, D
                                              ).transpose(1, 2)
    return dq, dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def write_slot(cache: torch.Tensor, slot: int, row: torch.Tensor) -> None:
    """``cache[:, slot] = row`` in place; on DTensors (the dry run) only
    the device holding the slot writes (``dist.regions.write_slot``)."""
    if is_dtensor(cache):
        RG.write_slot(cache, slot, row)
    else:
        cache[:, slot] = row


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """One query token per head (B, H, D) over the first ``cache_len``
    positions of the (B, S, G, D) cache: the CUDA kernel on the card, its
    plain version on the CPU. Unlike the reference layer it does not round
    q * scale and the softmax weights to the cache dtype: both stay
    float32, as in the TPU kernel. On DTensors (the dry run) it runs on
    each device's shards (``dist.regions.decode_attention``)."""
    if is_dtensor(k_cache):
        return RG.decode_attention(ops.decode_attention, q, k_cache,
                                   v_cache, cache_len)
    return ops.decode_attention(q, k_cache, v_cache, cache_len)
