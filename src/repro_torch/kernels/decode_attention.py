"""Single-token attention over a KV cache, the decode-step attention of
every LM layer: the port of ``repro.kernels.decode_attention``.

For each batch row and query head h (kv group g = h // rep, rep = H / G):
o[h] = softmax((q[h] * D^-1/2) . k[:n, g]) @ v[:n, g] over the first
n = min(cache_len, S) positions, computed in float32 from the stored
dtype and returned in q's dtype; n = 0 gives zeros.

:func:`decode_attention` launches the CUDA kernel
(``csrc/decode_attention.cuh``, built from ``csrc/decode_attention*.cu``,
one source per head dim): a split-KV decode, whose blocks each take one
range of the cache, and a combine of the ranges in split order;
:func:`choose_splits` picks the tile and cuts the cache on the host, and
``LAST_CUT`` holds the cut of the latest launch.
:func:`decode_attention_plain` is its plain PyTorch version (two einsums
and a softmax in float32), and :func:`decode_attention_split_plain` the
kernel's split-and-combine in PyTorch, for the tests.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import SMEM_LIMIT

HEAD_DIMS = (32, 64, 80, 128, 256)  # the kernel's head dims (template parameter)
MAX_REP = 16                   # query heads per kv head the kernel takes
# csrc/decode_attention.cuh's kSmallTile and kLargeTile: bytes of K (and
# of V) in a tile, with which the partial kernel fits two blocks on an SM,
# or one
SMALL_TILE = 24576
LARGE_TILE = 49152
BLOCKS_PER_SM = {SMALL_TILE: 2, LARGE_TILE: 1}
WARPS = 8                      # the partial kernel's 256 threads
THREADS = 32 * WARPS
# the latest launch's tile_bytes, splits and chunk (positions a split)
LAST_CUT: dict = {}


def _valid(cache_len, S: int) -> int:
    return max(0, min(int(cache_len), S))


def tile_positions(D: int, itemsize: int,
                   tile_bytes: int = SMALL_TILE) -> int:
    """Cache positions in one tile of ``tile_bytes`` (``Cfg::kTile``): as
    many rows as it holds, cut down to a multiple of four times the p @ v
    position groups (256 threads over the D / 2 column pairs), so that
    each group owns a whole, aligned share (144 rather than 153 at D 80
    in a small bfloat16 tile; every other head dim divides evenly)."""
    step = 4 * (THREADS // (D // 2))
    return tile_bytes // (D * itemsize) // step * step


def smem_bytes(D: int, itemsize: int, rep: int, tile_bytes: int) -> int:
    """The partial kernel's shared memory (``Cfg::kSmem``): two stages of
    K and V tiles, then float32 scores, queries, warp maxes and sums and
    the running state, for the power of two at or above ``rep``."""
    REP = 1 << max(0, rep - 1).bit_length()
    wpr = WARPS // REP if REP < WARPS else 1
    tile = tile_positions(D, itemsize, tile_bytes)
    return 4 * tile_bytes + 4 * (REP * tile + REP * D + WARPS * REP
                                 + REP * wpr + 4 * REP)


def split_chunk(n: int, splits: int, tile: int) -> int:
    """Positions per split when the first n positions are cut into
    ``splits`` ranges of whole tiles: split s covers [s * chunk,
    min((s + 1) * chunk, n)), which is empty where s * chunk >= n."""
    return -(-max(1, -(-n // tile)) // splits) * tile


def _cut(blocks: int, n: int, tile: int, slots: int):
    """(splits, chunk): as many splits as keep all ``blocks`` * splits in
    one wave of ``slots``, at most one per tile, then as few as cover n
    with that chunk, so none is empty."""
    want = max(1, slots // max(1, blocks))
    chunk = split_chunk(n, min(want, max(1, -(-n // tile))), tile)
    return max(1, -(-n // chunk)), chunk


def choose_splits(blocks: int, n: int, D: int, itemsize: int, sms: int,
                  rep: int = 1):
    """(tile_bytes, splits, chunk) for ``blocks`` = B * G over n positions.
    The large tile, one block an SM, where one tile holds the cache (one
    split, no combine) or its blocks fill the ``sms``; else the small
    tile, two blocks an SM, for up to twice the splits. The small tile
    also wherever the large one's scores of ``rep`` query rows overflow
    shared memory (D 32 in bfloat16 past 8 rows)."""
    large = tile_positions(D, itemsize, LARGE_TILE)
    tiles = -(-n // large)
    fits = smem_bytes(D, itemsize, rep, LARGE_TILE) <= SMEM_LIMIT
    if fits and (tiles <= 1 or blocks * tiles >= sms):
        return (LARGE_TILE, *_cut(blocks, n, large, sms))
    return (SMALL_TILE, *_cut(blocks, n, tile_positions(D, itemsize),
                              sms * BLOCKS_PER_SM[SMALL_TILE]))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, cache_len,
                                 splits: int) -> torch.Tensor:
    """The kernel's split-and-combine in PyTorch: the first n positions
    cut as :func:`split_chunk` cuts them over small tiles, each split's
    running max m, sum l and unnormalised p @ v in float32 (m = -inf,
    l = 0, acc = 0 for an empty split), then folded in split order:
    M = max m_s, w_s = exp(m_s - M) (0 where m_s = -inf), o = sum w_s
    acc_s / max(sum w_s l_s, 1e-30), in q's dtype."""
    B, H, D = q.shape
    S, G = k.shape[1], k.shape[2]
    n = _valid(cache_len, S)
    chunk = split_chunk(n, splits, tile_positions(D, q.element_size()))
    qf = q.to(torch.float32).reshape(B, G, H // G, D) * D ** -0.5
    state = []
    for s in range(splits):
        lo, hi = min(n, s * chunk), min(n, (s + 1) * chunk)
        if lo == hi:
            state.append((qf.new_full(qf.shape[:3], -math.inf),
                          qf.new_zeros(qf.shape[:3]), qf.new_zeros(qf.shape)))
            continue
        sc = torch.einsum("bgrd,bsgd->bgrs", qf, k[:, lo:hi].to(torch.float32))
        m = sc.amax(-1)
        p = torch.exp(sc - m.unsqueeze(-1))
        state.append((m, p.sum(-1), torch.einsum(
            "bgrs,bsgd->bgrd", p, v[:, lo:hi].to(torch.float32))))
    M = torch.stack([m for m, _, _ in state]).amax(0)
    num = qf.new_zeros(qf.shape)
    den = qf.new_zeros(qf.shape[:3])
    for m, l, acc in state:
        w = torch.where(torch.isinf(m), 0.0, torch.exp(m - M))
        num = num + w.unsqueeze(-1) * acc
        den = den + w * l
    o = num / den.clamp_min(1e-30).unsqueeze(-1)
    return o.reshape(B, H, D).to(q.dtype)


def _checked(q, k, v, cache_len):
    """The launcher's checks -> (contiguous q, n)."""
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
    return q, _valid(cache_len, S)


def _launch(q, k, v, n, tile_bytes, splits, chunk):
    B, H, D = q.shape
    out = torch.empty_like(q)
    part = (torch.empty(B * H * splits * (2 + D), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    build.call("decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), 0 if part is None else part.data_ptr(), B, H,
               k.shape[2], k.shape[1], D, n, splits, chunk, tile_bytes,
               int(q.dtype == torch.bfloat16), D ** -0.5)
    LAST_CUT.update(tile_bytes=tile_bytes, splits=splits, chunk=chunk)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len) -> torch.Tensor:
    """CUDA kernel: same contract as :func:`decode_attention_plain`, on
    the card, for float32 or bfloat16, D in ``HEAD_DIMS`` and
    H / G <= ``MAX_REP``; the cache cut by :func:`choose_splits`."""
    q, n = _checked(q, k, v, cache_len)
    B, H, D = q.shape
    G = k.shape[2]
    return _launch(q, k, v, n, *launch_cut(
        B * G, n, D, q.element_size(), _sm_count(q.device.index or 0),
        H // G))


_CUTS: dict = {}


def launch_cut(blocks: int, n: int, D: int, itemsize: int, sms: int,
               rep: int = 1):
    """(tile_bytes, splits, chunk) of a launch on the card: the autotune
    registry's tile and split count at exactly this (blocks, n, D, rep) and
    dtype, re-cut as :func:`split_chunk` cuts, where one is recorded and
    its tile fits; else :func:`choose_splits`. The splits change only the
    combine's rounding."""
    from repro_torch.kernels import autotune

    key = (blocks, n, D, itemsize, sms, rep, autotune.version)
    if key not in _CUTS:
        cfg = autotune.lookup(
            "decode_attention", (blocks, n, D, rep),
            "bfloat16" if itemsize == 2 else "float32", autotune.CARD,
            nearest=False)
        cut = choose_splits(blocks, n, D, itemsize, sms, rep)
        if cfg and cfg.get("tile_bytes") in (LARGE_TILE, SMALL_TILE) \
                and smem_bytes(D, itemsize, rep, cfg["tile_bytes"]) \
                <= SMEM_LIMIT and int(cfg.get("splits", 0)) >= 1:
            tile = cfg["tile_bytes"]
            chunk = split_chunk(n, int(cfg["splits"]),
                                tile_positions(D, itemsize, tile))
            cut = (tile, max(1, -(-n // chunk)), chunk)
        _CUTS[key] = cut
    return _CUTS[key]


def _decode_attention_splits(q, k, v, cache_len, splits: int):
    """The kernel over small tiles with ``splits`` ranges cut as
    :func:`split_chunk` cuts them. For the checks only: it reaches empty
    splits, which :func:`choose_splits` never makes."""
    q, n = _checked(q, k, v, cache_len)
    chunk = split_chunk(n, splits,
                        tile_positions(q.shape[2], q.element_size()))
    return _launch(q, k, v, n, SMALL_TILE, splits, chunk)
