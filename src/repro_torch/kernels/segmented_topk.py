"""Segmented age-top-k, the rAge-k selection phase: the port of
``repro.kernels.segmented_topk`` and of its oracle
``repro.core.strategies.segmented_age_topk``.

For every cluster, members s = 0..S-1 in order pick the k highest-age
lanes among their r candidates (|g|-descending), by k first-occurrence
argmax passes: ties go to the lower lane, i.e. the larger magnitude,
exactly as the stable ``lax.top_k``. With ``disjoint``, a candidate that
an earlier valid member of the same cluster picked is masked to age -1
first; a member's picks enter the cluster's taken buffer only when its
``valid`` slot is set. Ages are non-negative (the contract).

:func:`segmented_age_topk` launches the CUDA kernel
(``csrc/segmented_topk.cu``): one block per cluster where its shared
memory holds the cluster, else the same steps from device memory
(:func:`layout` decides from the shape); :func:`segmented_age_topk_plain` is its
plain PyTorch version; :func:`segmented_age_topk_ranked` repeats the
kernel's steps (rank every member's lanes at once, then walk the members
in order) in plain PyTorch, for the CPU tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import SMEM_LIMIT

NEG = -(2 ** 31) + 1              # a picked lane's age: never picked again
STATIC_SMEM = 1024                # the walk's own shared variables, rounded up


def _pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def layout(S: int, r: int, k: int) -> dict:
    """The kernel's launch for one cluster of S members of r lanes: each
    member's lanes padded to a power of two (``rp``), the taken set's hash
    slots (a power of two >= 2*S*k), and ``path``: "block" while one
    block's shared memory holds the cluster (ranked 64-bit keys with one
    pad slot after every 16, candidates, hash), else "global" (the
    ranked keys in device memory, and the hash in shared memory while it
    fits, ``hash_smem``). ``threads`` and ``smem`` (bytes) are those of the
    block that walks the members."""
    rp = _pow2(r)
    hash_ = max(32, _pow2(2 * S * k))
    smem = 8 * (S * rp + S * rp // 16) + 4 * (S * r + hash_)
    if smem <= SMEM_LIMIT:
        threads = min(1024, max(32, _pow2(S * rp // 8), _pow2(min(r, 1024))))
        return dict(rp=rp, hash=hash_, threads=threads, smem=smem,
                    path="block", hash_smem=True)
    hash_smem = 4 * hash_ <= SMEM_LIMIT - STATIC_SMEM
    return dict(rp=rp, hash=hash_, threads=min(1024, max(32, _pow2(min(
        r, 1024)))), smem=4 * hash_ if hash_smem else 0, path="global",
        hash_smem=hash_smem)


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
    """CUDA kernel: unpadded (C, S, r) inputs on the card (candidates int32,
    or int64 as the engine gathers them, read as they are), 1 <= k <= r ->
    (C, S, k) int32."""
    C, S, r = cand.shape
    if cand_age.shape != cand.shape or valid.shape != (C, S):
        raise ValueError(f"segmented_age_topk: cand {tuple(cand.shape)}, "
                         f"ages {tuple(cand_age.shape)} and valid "
                         f"{tuple(valid.shape)} do not agree")
    if not 1 <= k <= r:
        raise ValueError(f"segmented_age_topk: need 1 <= k <= r, got k={k}, "
                         f"r={r}")
    if cand.dtype != torch.int64:
        cand = cand.to(torch.int32)
    cand = cand.contiguous()
    cand_age = cand_age.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    lay = layout(S, r, k)
    build.require_cuda("segmented_age_topk", cand, cand_age, valid)
    dev = cand.device
    out = torch.empty((C, S, k), dtype=torch.int32, device=dev)
    keys = tab = None
    if lay["path"] == "global":
        keys = torch.empty((2, C * S * lay["rp"]), dtype=torch.int64,
                           device=dev)
        if not lay["hash_smem"]:
            tab = torch.empty((C, lay["hash"]), dtype=torch.int32, device=dev)
    build.call("segmented_age_topk", cand.data_ptr(), cand_age.data_ptr(),
               valid.data_ptr(), out.data_ptr(),
               None if keys is None else keys[0].data_ptr(),
               None if keys is None else keys[1].data_ptr(),
               None if tab is None else tab.data_ptr(), C, S, r, k,
               int(disjoint), int(cand.dtype == torch.int64), lay["rp"],
               lay["hash"], lay["threads"])
    return out


def segmented_age_topk_ranked(cand: torch.Tensor, cand_age: torch.Tensor,
                              valid: torch.Tensor, k: int, *,
                              disjoint: bool = True) -> torch.Tensor:
    """The kernel's steps in plain PyTorch: every member's lanes ranked at
    once by (age descending, lane ascending); then, member by member, the
    first k ranked lanes whose candidate is not taken, followed, if fewer
    than k are left, by the taken lanes in lane order. Equal to
    :func:`segmented_age_topk_plain` for non-negative ages."""
    C, S, r = cand.shape
    cand = cand.to(torch.int32)
    ranked = torch.sort(-cand_age.to(torch.int64), dim=-1,
                        stable=True).indices
    out = torch.empty((C, S, k), dtype=torch.int32)
    for c in range(C):
        taken: set[int] = set()
        for s in range(S):
            cs = cand[c, s].tolist()
            hit = [disjoint and (x == -1 or x in taken) for x in cs]
            lanes = [l for l in ranked[c, s].tolist() if not hit[l]]
            lanes += [l for l in range(r) if hit[l]]
            out[c, s] = torch.tensor([cs[l] for l in lanes[:k]])
            if disjoint and bool(valid[c, s]):
                taken.update(out[c, s].tolist())
    return out
