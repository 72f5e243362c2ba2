"""Magnitude histograms by exact float32 exponent, the first pass of the
threshold top-r candidate report: the port of ``repro.kernels.maghist``
(``maghist``, ``maghist_batch``, ``hist_rows``, ``exponent_bins``,
``threshold_from_hist`` and ``threshold_from_hist_batch``).

``bin = clip(exponent(|g|) - 127 + OFFSET, 0, NBINS - 1)`` read from the
bit pattern, never from ``log2``: the threshold containment argument
needs "mag in bin b implies mag >= 2^(b - OFFSET)" exactly. NaN goes to
bin 0 (never a candidate), +/-inf to the top bin, zeros and denormals to
bin 0.

Two kernels share the bin function (``csrc/exponent_bins.cuh``):
:func:`maghist_batch` (``csrc/maghist.cu``) writes one histogram per row,
:func:`hist_rows` is its plain version; :func:`maghist`
(``csrc/maghist_blocks.cu``) writes one histogram per 4096-block of each
row, :func:`hist_blocks` is its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NBINS = 64
OFFSET = 40          # exponent -40 .. +23 covered
BLOCK_D = 4096       # elements per block of the per-block histograms


def exponent_bins(mag: torch.Tensor) -> torch.Tensor:
    """|g| (float32, non-negative) -> int64 bin ids."""
    mag = mag.to(torch.float32)
    e = (mag.view(torch.int32) >> 23) & 0xFF
    b = (e - 127 + OFFSET).clamp(0, NBINS - 1).to(torch.int64)
    return torch.where(torch.isnan(mag), 0, b)


def hist_rows(G: torch.Tensor) -> torch.Tensor:
    """Plain version: (N, d) -> (N, NBINS) int32 row histograms by one
    ``scatter_add`` over d."""
    b = exponent_bins(G.to(torch.float32).abs())
    ones = torch.ones_like(b, dtype=torch.int32)
    return torch.zeros((G.shape[0], NBINS), dtype=torch.int32,
                       device=G.device).scatter_add_(1, b, ones)


def maghist_batch(G: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: (N, d) float32 on the card -> (N, NBINS) int32."""
    G = G.to(torch.float32).contiguous()
    build.require_cuda("maghist_batch", G)
    n, d = G.shape
    if n > 65535:
        raise ValueError(f"maghist_batch: at most 65535 rows, got {n}")
    hist = torch.zeros((n, NBINS), dtype=torch.int32, device=G.device)
    build.call("maghist_batch", G.data_ptr(), hist.data_ptr(), n, d)
    return hist


def hist_blocks(G: torch.Tensor) -> torch.Tensor:
    """Plain version: (d,) or (N, d) -> (..., ceil(d / BLOCK_D), NBINS)
    int32 per-block histograms. d is zero-padded to a BLOCK_D multiple, as
    the reference's wrapper pads, so the padding counts in bin 0 of the
    last block; then one ``scatter_add`` over the block axis."""
    rows = G.reshape(-1, G.shape[-1]).to(torch.float32)
    n, d = rows.shape
    nb = -(-d // BLOCK_D)
    rows = torch.nn.functional.pad(rows, (0, nb * BLOCK_D - d))
    b = exponent_bins(rows.abs()).view(n, nb, BLOCK_D)
    hist = torch.zeros((n, nb, NBINS), dtype=torch.int32, device=G.device)
    hist.scatter_add_(2, b, torch.ones_like(b, dtype=torch.int32))
    return hist.reshape(*G.shape[:-1], nb, NBINS)


def maghist(G: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: (d,) or (N, d) float32 on the card -> (...,
    ceil(d / BLOCK_D), NBINS) int32, every row in one launch."""
    rows = G.reshape(-1, G.shape[-1]).to(torch.float32).contiguous()
    build.require_cuda("maghist", rows)
    n, d = rows.shape
    if n > 65535:
        raise ValueError(f"maghist: at most 65535 rows, got {n}")
    nb = -(-d // BLOCK_D)
    hist = torch.empty((n, nb, NBINS), dtype=torch.int32, device=G.device)
    build.call("maghist", rows.data_ptr(), hist.data_ptr(), n, d)
    return hist.reshape(*G.shape[:-1], nb, NBINS)


def threshold_from_hist_batch(hist: torch.Tensor, r: int) -> torch.Tensor:
    """Per-row magnitude threshold: tau = 2^(b - OFFSET) for the largest
    bin b whose from-top count is >= r, and tau = 0 when b = 0 (the bottom
    bin also holds zeros and denormals). (N, NBINS) -> (N,) float32.
    tau is written as its float32 bit pattern (exponent field
    b - OFFSET + 127, zero mantissa), so it is exact on every device,
    with no ``pow`` or ``exp2`` whose rounding could differ."""
    from_top = hist.flip(-1).cumsum(-1).flip(-1)
    bin_sel = ((from_top >= r).sum(-1) - 1).to(torch.int32)
    tau = ((bin_sel - OFFSET + 127) << 23).view(torch.float32)
    return torch.where(bin_sel == 0, torch.zeros_like(tau), tau)


def threshold_from_hist(hist: torch.Tensor, r: int) -> torch.Tensor:
    """Threshold over per-block histograms: (..., nb, NBINS) -> (...,)
    float32, the blocks summed, then :func:`threshold_from_hist_batch`."""
    h = hist.sum(-2)
    return threshold_from_hist_batch(h.reshape(-1, NBINS),
                                     r).reshape(h.shape[:-1])
