"""Segmented age-top-k, the rAge-k selection phase: the port of
``repro.kernels.segmented_topk`` and of its oracle
``repro.core.strategies.segmented_age_topk``.

For every cluster, members s = 0..S-1 in order pick the k highest-age
lanes among their r candidates (|g|-descending), by k first-occurrence
argmax passes: ties go to the lower lane, i.e. the larger magnitude,
exactly as the stable ``lax.top_k``. With ``disjoint``, a candidate that
an earlier valid member of the same cluster picked is masked to age -1
first; a member's picks enter the cluster's taken buffer only when its
``valid`` slot is set.

:func:`segmented_age_topk` launches the CUDA kernel
(``csrc/segmented_topk.cu``); :func:`segmented_age_topk_plain` is its
plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG = -(2 ** 31) + 1              # a picked lane's age: never picked again
_SMEM_LIMIT = 48 * 1024           # default dynamic shared memory per block


def segmented_age_topk_plain(cand: torch.Tensor, cand_age: torch.Tensor,
                             valid: torch.Tensor, k: int, *,
                             disjoint: bool = True) -> torch.Tensor:
    """cand/cand_age: (C, S, r) candidate indices and non-negative ages;
    valid: (C, S) live-member mask -> (C, S, k) int32 picks. The member
    loop runs in order; clusters are batched."""
    C, S, r = cand.shape
    cand = cand.to(torch.int32)
    ages = cand_age.to(torch.int32)
    valid = valid.to(torch.bool)
    out = torch.empty((C, S, k), dtype=torch.int32, device=cand.device)
    taken = torch.full((C, S * k), -1, dtype=torch.int32, device=cand.device)
    for s in range(S):
        c, a = cand[:, s], ages[:, s].clone()
        if disjoint:
            hit = (c.unsqueeze(-1) == taken.unsqueeze(1)).any(-1)
            a = torch.where(hit, torch.full_like(a, -1), a)
        for j in range(k):
            p = a.argmax(dim=1, keepdim=True)      # first maximal lane
            out[:, s, j] = c.gather(1, p).squeeze(1)
            a.scatter_(1, p, NEG)
        if disjoint:
            taken[:, s * k:(s + 1) * k] = torch.where(
                valid[:, s, None], out[:, s], torch.full_like(out[:, s], -1))
    return out


def segmented_age_topk(cand: torch.Tensor, cand_age: torch.Tensor,
                       valid: torch.Tensor, k: int, *,
                       disjoint: bool = True) -> torch.Tensor:
    """CUDA kernel: unpadded (C, S, r) int32 inputs on the card, 1 <= k <= r
    -> (C, S, k) int32."""
    C, S, r = cand.shape
    if cand_age.shape != cand.shape or valid.shape != (C, S):
        raise ValueError(f"segmented_age_topk: cand {tuple(cand.shape)}, "
                         f"ages {tuple(cand_age.shape)} and valid "
                         f"{tuple(valid.shape)} do not agree")
    if not 1 <= k <= r:
        raise ValueError(f"segmented_age_topk: need 1 <= k <= r, got k={k}, "
                         f"r={r}")
    cand = cand.to(torch.int32).contiguous()
    cand_age = cand_age.to(torch.int32).contiguous()
    valid = valid.to(torch.int32).contiguous()
    build.require_cuda("segmented_age_topk", cand, cand_age, valid)
    smem = 4 * (2 * r + S * k + k)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"segmented_age_topk: r={r}, S={S}, k={k} need "
                         f"{smem} B of shared memory (> {_SMEM_LIMIT})")
    out = torch.empty((C, S, k), dtype=torch.int32, device=cand.device)
    build.call("segmented_age_topk", cand.data_ptr(), cand_age.data_ptr(),
               valid.data_ptr(), out.data_ptr(), C, S, r, k, int(disjoint))
    return out
