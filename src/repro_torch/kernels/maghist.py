"""Magnitude histograms by exact float32 exponent, the first pass of the
threshold top-r candidate report: the port of ``repro.kernels.maghist``
(``maghist``, ``maghist_batch``, ``hist_rows``, ``exponent_bins``,
``threshold_from_hist`` and ``threshold_from_hist_batch``).

``bin = clip(exponent(|g|) - 127 + OFFSET, 0, NBINS - 1)`` read from the
bit pattern, never from ``log2``: the threshold containment argument
needs "mag in bin b implies mag >= 2^(b - OFFSET)" exactly. NaN goes to
bin 0 (never a candidate), +/-inf to the top bin, zeros and denormals to
bin 0.

Three kernels share the bin function (``csrc/exponent_bins.cuh``):
:func:`maghist_batch` (``csrc/maghist.cu``) writes one histogram per row,
:func:`hist_rows` is its plain version; its first kernel, the counts of
each block of a row, is also the first pass of the candidate report
(``kernels/report.py``, whose second pass is ``csrc/report.cu``);
:func:`maghist` (``csrc/maghist_blocks.cu``) writes one histogram per
4096-block of each row, :func:`hist_blocks` is its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NBINS = 64
OFFSET = 40          # exponent -40 .. +23 covered
BLOCK_D = 4096       # elements per block of the per-block histograms
MAX_PARTS = 64       # blocks per row of maghist_batch and the report
SUB_BITS = 2         # the report's fine bins: quarter binades
SLOTS = (NBINS << SUB_BITS) + 1   # a block's counts: fine bins, then NaN


def chunk_for(d: int) -> int:
    """The elements of a row that one block of :func:`maghist_batch` (and
    of the report's second pass) owns: the least multiple of ``BLOCK_D``
    that cuts d into at most ``MAX_PARTS`` blocks, so that every block of
    the second pass can sum its row's block counts."""
    return BLOCK_D * -(-d // (BLOCK_D * MAX_PARTS))


_CHUNKS: dict = {}


def launch_chunk(n: int, d: int) -> int:
    """The chunk of a launch on the card over (n, d): the autotune
    registry's blocks a row for ``maghist_batch`` at this shape (or the
    nearest recorded one), as the chunk that cuts d into at most that many
    blocks; :func:`chunk_for` where there is none or it is out of range.
    The candidate report's two launches take the same chunk. Only the
    integer counts' grouping changes, never a result."""
    from repro_torch.kernels import autotune

    key = (n, d, autotune.version)
    if key not in _CHUNKS:
        cfg = autotune.lookup("maghist_batch", (n, d), "float32",
                              autotune.CARD)
        parts = cfg.get("parts") if cfg else None
        chunk = chunk_for(d)
        if isinstance(parts, int) and 1 <= parts <= MAX_PARTS:
            chunk = max(chunk, BLOCK_D * -(-d // (BLOCK_D * parts)))
        _CHUNKS[key] = chunk
    return _CHUNKS[key]


def exponent_bins(mag: torch.Tensor) -> torch.Tensor:
    """|g| (float32, non-negative) -> int64 bin ids."""
    mag = mag.to(torch.float32)
    e = (mag.view(torch.int32) >> 23) & 0xFF
    b = (e - 127 + OFFSET).clamp(0, NBINS - 1).to(torch.int64)
    return torch.where(torch.isnan(mag), 0, b)


def fine_slots(G: torch.Tensor) -> torch.Tensor:
    """The report's count slot of every value (``report_slot`` in
    ``csrc/exponent_bins.cuh``): NaN -> SLOTS - 1, else bin * 4 + the top
    two mantissa bits, bin * 4 alone in the edge bins 0 and 63. Slots are
    ordered as the magnitudes are; int64."""
    mag = G.to(torch.float32).abs()
    b = exponent_bins(mag)
    sub = (mag.view(torch.int32) >> (23 - SUB_BITS)) & ((1 << SUB_BITS) - 1)
    sub = torch.where((b == 0) | (b == NBINS - 1), 0, sub)
    return torch.where(torch.isnan(mag), SLOTS - 1, (b << SUB_BITS) | sub)


def hist_rows(G: torch.Tensor) -> torch.Tensor:
    """Plain version: (N, d) -> (N, NBINS) int32 row histograms by one
    ``scatter_add`` over d."""
    b = exponent_bins(G.to(torch.float32).abs())
    ones = torch.ones_like(b, dtype=torch.int32)
    return torch.zeros((G.shape[0], NBINS), dtype=torch.int32,
                       device=G.device).scatter_add_(1, b, ones)


def _launch_counts(G: torch.Tensor, ctr, rows: bool):
    G = G.to(torch.float32).contiguous()
    build.require_cuda("maghist_batch", G)
    n, d = G.shape
    if not (1 <= n <= 65535 and d >= 1):
        raise ValueError(f"maghist_batch: needs 1 to 65535 rows and d >= 1, "
                         f"got {tuple(G.shape)}")
    chunk = launch_chunk(n, d)
    counts = torch.empty((n, -(-d // chunk), SLOTS), dtype=torch.int32,
                         device=G.device)
    hist = (torch.empty((n, NBINS), dtype=torch.int32, device=G.device)
            if rows else None)
    build.call("maghist_batch", G.data_ptr(), counts.data_ptr(),
               None if ctr is None else ctr.data_ptr(),
               None if hist is None else hist.data_ptr(), n, d, chunk)
    return counts, hist


def maghist_batch(G: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: (N, d) float32 on the card -> (N, NBINS) int32. One
    launch count, two kernels: the counts of each block of a row
    (:func:`block_counts`), then their sum per row and bin in block
    order."""
    return _launch_counts(G, None, rows=True)[1]


def block_counts(G: torch.Tensor, ctr: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """CUDA kernel: (N, d) float32 on the card -> (N, ceil(d / chunk),
    SLOTS) int32: each block's counts by :func:`fine_slots` (``chunk_for(d)``
    elements a block); the four fine bins of bin b sum to bin b. Also
    zeroes ``ctr`` (N,) int32, the report's hand-off counters, when
    given."""
    return _launch_counts(G, ctr, rows=False)[0]


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
