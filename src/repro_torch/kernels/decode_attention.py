"""Single-token attention over a KV cache, the decode-step attention of
every LM layer: the port of ``repro.kernels.decode_attention``.

For each batch row and query head h (kv group g = h // rep, rep = H / G):
o[h] = softmax((q[h] * D^-1/2) . k[:n, g]) @ v[:n, g] over the first
n = min(cache_len, S) positions, computed in float32 from the stored
dtype and returned in q's dtype; n = 0 gives zeros.

:func:`decode_attention` launches the CUDA kernel
(``csrc/decode_attention.cuh``, built from ``csrc/decode_attention*.cu``,
one source per head dim); :func:`decode_attention_plain` is its
plain PyTorch version (two einsums and a softmax in float32).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 128, 256)     # the kernel's head dims (template parameter)
MAX_REP = 16                   # query heads per kv head the kernel takes


def _valid(cache_len, S: int) -> int:
    return max(0, min(int(cache_len), S))


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, cache_len) -> torch.Tensor:
    """q (B, H, D), k/v (B, S, G, D), cache_len a host int -> (B, H, D)
    in q's dtype. Positions >= cache_len are masked by leaving them out,
    as the kernel never reads them."""
    B, H, D = q.shape
    S, G = k.shape[1], k.shape[2]
    n = _valid(cache_len, S)
    if n == 0:
        return torch.zeros_like(q)
    qf = q.to(torch.float32).reshape(B, G, H // G, D) * D ** -0.5
    s = torch.einsum("bgrd,bsgd->bgrs", qf, k[:, :n].to(torch.float32))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", p, v[:, :n].to(torch.float32))
    return o.reshape(B, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len) -> torch.Tensor:
    """CUDA kernel: same contract as :func:`decode_attention_plain`, on
    the card, for float32 or bfloat16, D in ``HEAD_DIMS`` and
    H / G <= ``MAX_REP``."""
    B, H, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} needs k and "
                         f"v of shape (B, S, G, D), got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    S, G = k.shape[1], k.shape[2]
    if G == 0 or H % G or H // G > MAX_REP or D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: the kernel takes H % G == 0, "
                         f"H / G <= {MAX_REP} and D in {HEAD_DIMS}; got "
                         f"H={H}, G={G}, D={D}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: float32 or bfloat16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    q = q.contiguous()
    build.require_cuda("decode_attention", q, k, v)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    build.call("decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), B, H, G, S, D, _valid(cache_len, S),
               int(q.dtype == torch.bfloat16), D ** -0.5)
    return out
