"""Multi-head Latent Attention (DeepSeek-V2): the port of
``repro.models.mla``.

A token's KV state is a rank-``kv_lora_rank`` latent c_kv plus one
64-wide RoPE key shared by every head, so the decode cache holds R + 64
values a token instead of 2 H hd. Prefill expands the latent to full K
and V and runs the port's chunked ``flash_attention`` (q and k of width
hd + 64, v of width hd); decode absorbs the up-projections into the
query and the output and attends in latent space. Both are plain
PyTorch, as the reference computes them in jnp: the latent cache is one
"kv head" under H query heads, past the decode kernel's ``MAX_REP``.
"""
from __future__ import annotations

import torch

from repro_torch.dist import regions as RG
from repro_torch.dist import sharding as SH
from repro_torch.models import layers as L

ROPE_DIM = 64


def mla_params(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    d, hd, H, R = cfg.d_model, cfg.head_dim_, cfg.n_heads, cfg.kv_lora_rank
    dtype = L.dtype_of(cfg)
    return {
        "wq": L.dense_init(gen, d, H * (hd + ROPE_DIM), dtype, lead),
        "w_dkv": L.dense_init(gen, d, R, dtype, lead),       # latent down
        "w_kr": L.dense_init(gen, d, ROPE_DIM, dtype, lead),  # shared rope key
        "w_uk": L.dense_init(gen, R, H * hd, dtype, lead),   # latent -> K
        "w_uv": L.dense_init(gen, R, H * hd, dtype, lead),   # latent -> V
        "wo": L.dense_init(gen, H * hd, d, dtype, lead),
    }


def _split_q(cfg, q):
    B, S = q.shape[:2]
    hd = cfg.head_dim_
    q = q.reshape(B, S, cfg.n_heads, hd + ROPE_DIM)
    return q[..., :hd], q[..., hd:]


def mla_prefill(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                kv_chunk: int = 1024):
    """x (B, S, d) -> (out (B, S, d), (c_kv (B, S, R), k_rope (B, S, 64))):
    causal attention over the latent expanded to per-head K (its no-RoPE
    part, beside the shared RoPE key) and V."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim_
    q_nope, q_rope = _split_q(cfg, x @ p["wq"])
    q_rope = L.rope(q_rope, positions, cfg.rope_theta)
    c_kv = x @ p["w_dkv"]
    k_rope = L.rope((x @ p["w_kr"])[:, :, None, :], positions,
                    cfg.rope_theta)
    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, H, hd)
    v = (c_kv @ p["w_uv"]).reshape(B, S, H, hd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, ROPE_DIM)], dim=-1)
    out = L.flash_attention(q, k, v, causal=True, kv_chunk=kv_chunk)
    return out.reshape(B, S, H * hd) @ p["wo"], (c_kv, k_rope[:, :, 0])


def mla_decode(p: dict, cfg, x: torch.Tensor, c_kv: torch.Tensor,
               k_rope: torch.Tensor, pos: int) -> torch.Tensor:
    """x (B, 1, d); the caches c_kv (B, S, R) and k_rope (B, S, 64) get
    this token's rows at ``pos`` (a host int) in place (none past the
    last slot, as the reference's scatter drops it); returns (B, 1, d).
    Scores in latent space: q_nope absorbed through w_uk, summed over the
    first pos + 1 positions in float32, the context taken back through
    w_uv; each product rounded to the model dtype where the reference
    rounds it."""
    B = x.shape[0]
    H, hd, R = cfg.n_heads, cfg.head_dim_, cfg.kv_lora_rank
    S = c_kv.shape[1]
    posv = torch.full((B, 1), pos, device=x.device)
    q_nope, q_rope = _split_q(cfg, x @ p["wq"])                # (B,1,H,*)
    q_rope = L.rope(q_rope, posv, cfg.rope_theta)
    if pos < S:
        L.write_slot(c_kv, pos, (x @ p["w_dkv"])[:, 0])
        L.write_slot(k_rope, pos, L.rope((x @ p["w_kr"])[:, :, None, :],
                                         posv, cfg.rope_theta)[:, 0, 0])
    f32 = torch.float32
    n = min(pos + 1, S)
    # q_lat[b, h, r] = q_nope[b, h, :] . w_uk[r, h, :]
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0],
                         p["w_uk"].reshape(R, H, hd))
    s = torch.einsum("bhr,bsr->bhs", q_lat.to(f32), c_kv[:, :n].to(f32))
    s = s + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].to(f32),
                         k_rope[:, :n].to(f32))
    pr = torch.softmax(s * (hd + ROPE_DIM) ** -0.5, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", pr.to(x.dtype), c_kv[:, :n])
    o = torch.einsum("bhr,rhd->bhd", ctx, p["w_uv"].reshape(R, H, hd))
    if SH.is_dtensor(o):
        return RG.merge_heads(o, p["wo"])
    return o.reshape(B, 1, H * hd) @ p["wo"]
