"""The candidate report on the card: for each row of G (N, d) the stable
top-r of ``where(isnan, -1, |g|)``, (N, r) int32 indices with ties to the
lower index, equal to ``vmap(lax.top_k(|g|, r)[1])`` for NaN-free G, and
on request the (N, r) float32 magnitudes at them (-1 at a NaN lane). The
port of ``repro.kernels.ops.threshold_topk_batch`` (the ``maghist_batch``
Pallas kernel and its XLA epilogue), and on the card of the baselines'
``ops.threshold_topk`` too (the ``maghist`` Pallas kernel's report).

:func:`threshold_topk_batch` makes two launches and no library call: the
blocks' counts (``maghist.block_counts``, ``csrc/maghist.cu``),
then ``csrc/report.cu``, which finds the threshold bin, compacts the
survivors in index order, refines the threshold bin by radix digits until
what it gathers fits its sort buffer, and sorts that in shared memory.
Past r = ``MAX_R`` the sort buffer lives in device memory and the second
launch also sorts it there (``csrc/gsort.cuh``: runs of ``MAX_R`` pairs,
then merge passes).
The counts and the threshold bin are by fine bin, a quarter binade
(``maghist.fine_slots``), whose sums are the exponent histogram.
:func:`threshold_topk_batch_plain` is the plain version (the histogram,
the threshold tau and a stable sort of the masked row);
:func:`threshold_topk_batch_steps` repeats the kernel's steps in plain
PyTorch, so the CPU tests can drive every branch of them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import maghist as MH

MAX_R = 8192          # the largest shared sort buffer: 68 KB of padded keys
DIGITS = 256          # the first refine digit's counts, per block
PAD_KEY = torch.iinfo(torch.int64).max   # above every (|g|, index) key


def _pow2_cap(r: int) -> int:
    return max(256, 1 << (r + r // 2 - 1).bit_length())


def sort_cap_for(r: int) -> int:
    """The report's sort buffer in pairs: the power of two at or above
    1.5 r, at least 256; in shared memory (at most MAX_R) while r <= MAX_R,
    past that in device memory."""
    return min(MAX_R, _pow2_cap(r)) if r <= MAX_R else _pow2_cap(r)


def masked_topr(mag: torch.Tensor, tau: torch.Tensor, r: int):
    """Non-candidates (|g| < tau, and NaN) drop to -1; the survivors get a
    stable descending sort, ties to the lower index as ``lax.top_k`` does
    (``torch.topk`` promises no order on ties). Returns (vals, idx) of the
    first r."""
    masked = torch.where(mag >= tau.unsqueeze(1), mag,
                         torch.full_like(mag, -1.0))
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    return vals[:, :r], idx[:, :r]


def threshold_topk_plain(rows: torch.Tensor, r: int):
    """Plain version of the baselines' report, the JAX package's
    ``ops.threshold_topk`` row by row: the per-block histograms
    (``maghist.hist_blocks``) give tau, then the stable top-r of the
    masked rows. (N, d) -> (vals float32, idx int64), each (N, r)."""
    tau = MH.threshold_from_hist(MH.hist_blocks(rows), r)
    return masked_topr(rows.to(torch.float32).abs(), tau, r)


def threshold_topk_batch_plain(G: torch.Tensor, r: int) -> torch.Tensor:
    """Plain version: the row histograms give tau, then the stable top-r of
    the candidates {|g| >= tau}. (N, d) -> (N, r) int32."""
    mag = G.to(torch.float32).abs()
    tau = MH.threshold_from_hist_batch(MH.hist_rows(G), r)
    return masked_topr(mag, tau, r)[1].to(torch.int32)


def threshold_topk_batch(G: torch.Tensor, r: int, *, vals: bool = False):
    """CUDA kernels: (N, d) float32 on the card, 1 <= r <= d -> (N, r)
    int32 indices, or (vals (N, r) float32, indices) with ``vals``. Two
    launches (``maghist_batch``'s counts, then ``threshold_topk_batch``);
    scratch of 8 bytes per element of G holds the compacted survivors, and
    past r = MAX_R two (N, ``sort_cap_for(r)``) int64 buffers the sort."""
    G = G.to(torch.float32).contiguous()
    build.require_cuda("threshold_topk_batch", G)
    n, d = G.shape
    if not 1 <= r <= d:
        raise ValueError(f"threshold_topk_batch: needs 1 <= r <= d, got "
                         f"r={r}, d={d}")
    cap = sort_cap_for(r)
    ctr = torch.empty(n, dtype=torch.int32, device=G.device)
    counts = MH.block_counts(G, ctr)
    dcounts = torch.empty((*counts.shape[:2], DIGITS), dtype=torch.int32,
                          device=G.device)
    skey = torch.empty((n, d), dtype=torch.int32, device=G.device)
    sidx = torch.empty((n, d), dtype=torch.int32, device=G.device)
    out = torch.empty((n, r), dtype=torch.int32, device=G.device)
    ov = (torch.empty((n, r), dtype=torch.float32, device=G.device)
          if vals else None)
    gbuf = (torch.empty((2, n, cap), dtype=torch.int64, device=G.device)
            if cap > MAX_R else None)
    build.call("threshold_topk_batch", G.data_ptr(), counts.data_ptr(),
               ctr.data_ptr(), dcounts.data_ptr(), skey.data_ptr(),
               sidx.data_ptr(), out.data_ptr(),
               None if ov is None else ov.data_ptr(),
               None if gbuf is None else gbuf[0].data_ptr(),
               None if gbuf is None else gbuf[1].data_ptr(), n, d,
               MH.chunk_for(d), r, cap)
    return (ov, out) if vals else out


def _sort_keys(keys: torch.Tensor, cap: int, run: int) -> torch.Tensor:
    """int64 keys padded to ``cap`` and sorted ascending, as the kernels
    sort them: in one piece while ``cap`` <= ``run``, else in runs of
    ``run`` keys, then merge passes that place each key at its index in its
    run plus its rank in the partner run (keys below it for the left run,
    at or below it for the right)."""
    keys = torch.cat([keys, torch.full((cap - len(keys),), PAD_KEY)])
    if cap <= run:
        return keys.sort().values
    keys = keys.view(-1, run).sort(dim=1).values.reshape(-1)
    w = run
    while w < cap:
        pair = keys.view(-1, 2, w)
        a, b = pair[:, 0].contiguous(), pair[:, 1].contiguous()
        own = torch.arange(w).expand_as(a)
        out = torch.empty((len(pair), 2 * w), dtype=torch.int64)
        out.scatter_(1, own + torch.searchsorted(b, a), a)
        out.scatter_(1, own + torch.searchsorted(a, b, right=True), b)
        keys, w = out.reshape(-1), 2 * w
    return keys


def threshold_topk_batch_steps(G: torch.Tensor, r: int, *,
                               chunk: int | None = None,
                               sort_cap: int | None = None,
                               vals: bool = False):
    """The kernels' steps in plain PyTorch, a row at a time: the blocks'
    counts of ``chunk`` elements each by fine bin (``maghist.fine_slots``),
    the threshold fine bin b, the compaction [values above b | b's values |
    NaN lanes] by the blocks' offsets, the radix refine of b's keys until
    the gathered pairs fit the sort buffer (or one key is left, whose first
    holders in index order are taken), then the sort by (|g| bits
    descending, index ascending). ``sort_cap`` is what one shared-memory
    sort holds (default as the kernel: ``sort_cap_for(r)``, and ``MAX_R``
    past r = MAX_R): for r <= sort_cap the buffer is ``sort_cap`` pairs in
    one sort; past it the buffer is the power of two at or above 1.5 r,
    sorted in runs of ``sort_cap`` and merged (the kernel's device-memory
    path). With ``vals``, returns (|g| at each index, -1 at NaN lanes;
    indices)."""
    G = G.to(torch.float32)
    n, d = G.shape
    chunk = chunk or MH.chunk_for(d)
    run = sort_cap or MAX_R
    if sort_cap is None:
        sort_cap = sort_cap_for(r)
    elif sort_cap < r:
        sort_cap = _pow2_cap(r)
    if not (1 <= r <= d and (sort_cap <= run or run & (run - 1) == 0)):
        raise ValueError(f"needs 1 <= r <= d and a power-of-two sort_cap "
                         f"below r, got r={r}, d={d}, sort_cap={run}")
    nan_slot = MH.SLOTS - 1
    keys = G.abs().view(torch.int32)
    slots = MH.fine_slots(G)
    out = torch.empty((n, r), dtype=torch.int32)
    out_vals = torch.empty((n, r), dtype=torch.float32)
    for row in range(n):
        blocks = list(zip(slots[row].split(chunk), keys[row].split(chunk),
                          torch.arange(d, dtype=torch.int32).split(chunk)))
        counts = torch.stack([torch.bincount(s, minlength=MH.SLOTS)
                              for s, _, _ in blocks])
        hist = counts.sum(0)
        above, b = 0, 0           # fine bin 0 means tau = 0
        for f in range(nan_slot - 1, 0, -1):
            if above + hist[f] >= r:
                b = f
                break
            above += int(hist[f])
        n2 = int(hist[b])
        nan_need = max(0, r - above - n2)
        # compaction, each block at the offsets its predecessors' counts give
        bkey = torch.zeros(d, dtype=torch.int32)
        bidx = torch.zeros(d, dtype=torch.int32)
        off = [0, above, above + n2]
        end = [above, above + n2, above + n2 + nan_need]
        for (s, k, i), c in zip(blocks, counts):
            for j, sel in enumerate(((s < nan_slot) & (s > b), s == b,
                                     s == nan_slot)):
                ids = i[sel][:max(0, end[j] - off[j])]
                bkey[off[j]:off[j] + len(ids)] = k[sel][:len(ids)]
                bidx[off[j]:off[j] + len(ids)] = ids
            off[0] += int(c[b + 1:nan_slot].sum())
            off[1] += int(c[b])
            off[2] += int(c[nan_slot])
        # refine bin b's key range until the gathered pairs fit
        tk, ti = bkey[above:above + n2], bidx[above:above + n2]
        m = r - above
        bin_, sub = b >> MH.SUB_BITS, b & ((1 << MH.SUB_BITS) - 1)
        edge = bin_ in (0, MH.NBINS - 1)
        shift = 31 if edge else 23 - MH.SUB_BITS
        prefix = 0 if edge else ((bin_ - MH.OFFSET + 127) << 23
                                 | sub << shift)
        c_gt, n_r = 0, n2
        while above + c_gt + n_r > sort_cap and shift > 0:
            w = min(8, shift)
            s = shift - w
            inside = (tk >> shift) == (prefix >> shift)
            h = torch.bincount((tk[inside] >> s) & ((1 << w) - 1),
                               minlength=1 << w)
            cum, dg = 0, (1 << w) - 1
            while dg > 0 and c_gt + cum + int(h[dg]) < m:
                cum += int(h[dg])
                dg -= 1
            c_gt += cum
            n_r = int(h[dg])
            prefix |= dg << s
            shift = s
        if above + c_gt + n_r <= sort_cap:
            take = (tk >> shift) >= (prefix >> shift)
        else:                      # one key left: its first holders
            eq = torch.nonzero(tk == prefix).squeeze(1)[:m - c_gt]
            take = tk > prefix
            take[eq] = True
        gk = torch.cat([bkey[:above], tk[take]]).to(torch.int64)
        gi = torch.cat([bidx[:above], ti[take]]).to(torch.int64)
        got = _sort_keys((0x7FFFFFFF - gk) << 32 | gi, sort_cap,
                         run)[:min(r, len(gi))]
        fill = bidx[above + n2:above + n2 + (r - len(got))]
        out[row] = torch.cat([(got & 0xFFFFFFFF).to(torch.int32), fill])
        out_vals[row] = torch.cat([
            (0x7FFFFFFF - (got >> 32)).to(torch.int32).view(torch.float32),
            torch.full((len(fill),), -1.0)])
    return (out_vals, out) if vals else out
