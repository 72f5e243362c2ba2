"""Per-row magnitude histograms by exact float32 exponent, the first pass
of the threshold top-r candidate report: the port of
``repro.kernels.maghist`` (``maghist_batch``, ``hist_rows``,
``exponent_bins``, ``threshold_from_hist_batch``).

``bin = clip(exponent(|g|) - 127 + OFFSET, 0, NBINS - 1)`` read from the
bit pattern, never from ``log2``: the threshold containment argument
needs "mag in bin b implies mag >= 2^(b - OFFSET)" exactly. NaN goes to
bin 0 (never a candidate), +/-inf to the top bin, zeros and denormals to
bin 0.

:func:`maghist_batch` launches the CUDA kernel (``csrc/maghist.cu``);
:func:`hist_rows` is its plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NBINS = 64
OFFSET = 40          # exponent -40 .. +23 covered


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
