"""Mixture-of-Experts FFN with capacity dispatch: the port of
``repro.models.moe``.

Each token's float32 router logits pick its top K experts (ties to the
lower expert index, as ``lax.top_k`` breaks them), its gates are the
softmax of those K logits, and each (token, slot) assignment takes the
next free row of its expert's (C, d) buffer in flat (token, slot) order;
an assignment past the capacity C is dropped. The experts' three
products run batched over (E, C, d), accumulated in float32 and cast to
the activations' dtype, and the gated rows are gathered back and summed
over the K slots; shared experts add one MLP over every token.

One token block: the reference cuts blocks only under an active mesh,
which its ``launch.train`` and ``launch.serve`` never enter; the block
cut comes with the model axis (ROADMAP queue 1, item 16.9). Dispatch and
combine are plain PyTorch, as they are jnp outside any Pallas kernel in
the reference. They add no float atomics: every kept (expert, row) pair
receives exactly one token's row, and the dropped ones go to a spare row
that nothing reads.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L


def moe_params(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    """The router (d, E) in float32, the expert stacks (E, d_in, d_out) at
    N(0, 1/d_in) in the model dtype, and, with shared experts, one MLP of
    width ``n_shared_experts * moe_hidden``; ``lead`` stacks them."""
    d, f, E = cfg.d_model, cfg.moe_hidden, cfg.n_experts
    dtype = L.dtype_of(cfg)
    experts = (*lead, E)
    p = {
        "router": L.dense_init(gen, d, E, torch.float32, lead),
        "experts_w1": L.dense_init(gen, d, f, dtype, experts),
        "experts_w3": L.dense_init(gen, d, f, dtype, experts),
        "experts_w2": L.dense_init(gen, f, d, dtype, experts),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_params(gen, cfg, lead,
                                   cfg.n_shared_experts * cfg.moe_hidden)
    return p


def capacity(cfg, n_tokens: int) -> int:
    """Rows an expert holds: cf * T * K / E, at least 8, a multiple of 8."""
    c = int(cfg.capacity_factor * n_tokens * cfg.experts_per_token
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def top_k(logits: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest in descending order,
    equal values in ascending index order (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _position_in_expert(flat_ids: torch.Tensor, E: int) -> torch.Tensor:
    """Exclusive rank of each assignment within its expert, in flat
    (token, slot) order: one cumsum of the one-hot, laid out (E, TK) so
    that the scan runs along contiguous memory (a scan down the outer
    axis of (TK, E) took 1.5 ms a layer at granite's 8,192 x 40 on the
    H100). The reference's chunked prefix sum exists for GSPMD; the
    integers are the same."""
    oh = (torch.arange(E, device=flat_ids.device)[:, None]
          == flat_ids[None, :]).to(torch.int32)
    before = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh
    return before.gather(0, flat_ids[None, :])[0]


def route(router: torch.Tensor, cfg, xt: torch.Tensor) -> dict:
    """Routing of T tokens xt (T, d): float32 ``logits`` (T, E), ``gates``
    (T, K) float32, expert ``ids`` (T, K), each assignment's ``pos`` in
    its expert and ``keep`` (pos < C), flat (T * K,), and the capacity
    ``C``."""
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = xt.to(torch.float32) @ router
    gate_k, ids = top_k(logits, K)
    pos = _position_in_expert(ids.reshape(-1), E)
    C = capacity(cfg, xt.shape[0])
    return dict(logits=logits, gates=torch.softmax(gate_k, dim=-1), ids=ids,
                pos=pos, keep=pos < C, C=C)


def apply_moe(p: dict, cfg, x: torch.Tensor):
    """x: (B, S, d) -> (y (B, S, d), aux) with aux = {"lb_loss" (the
    Switch load-balance loss E * sum(mean softmax * top-1 share)),
    "drop_frac" (the dropped share of the T * K assignments)}, float32
    0-d tensors."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.experts_per_token
    xt = x.reshape(T, d)
    r = route(p["router"], cfg, xt)
    C = r["C"]
    flat_ids = r["ids"].reshape(-1)
    # each kept assignment's row of the (E * C + 1, d) buffer; the dropped
    # ones share the spare last row, which nothing reads
    slot = torch.where(r["keep"], flat_ids * C + r["pos"], E * C)
    xe = xt[:, None, :].expand(T, K, d).reshape(T * K, d)
    buf = xt.new_zeros((E * C + 1, d)).index_copy(0, slot, xe)
    buf = buf[:E * C].reshape(E, C, d)

    # bfloat16 products summed in float32 and cast back, on the card's
    # cuBLAS and the CPU's BLAS alike: the reference's TPU artifact
    a = L.act_fn(cfg.act)
    h = a(torch.bmm(buf, p["experts_w1"])) * torch.bmm(buf, p["experts_w3"])
    out = torch.bmm(h, p["experts_w2"]).reshape(E * C, d)
    out = torch.cat([out, out.new_zeros((1, d))])      # the spare row: 0
    # index_select: its backward adds into the spare row's many repeats
    # at once, where indexing's sorts and walks them one by one
    y = out.index_select(0, slot).reshape(T, K, d) * r["gates"][
        ..., None].to(x.dtype)
    y = y.sum(dim=1)
    if cfg.n_shared_experts:
        y = y + L.apply_mlp(p["shared"], cfg, xt)

    me = torch.softmax(r["logits"], dim=-1).mean(dim=0)
    ce = torch.nn.functional.one_hot(r["ids"][:, 0], E).to(
        torch.float32).mean(dim=0)
    aux = {"lb_loss": E * torch.sum(me * ce),
           "drop_frac": 1.0 - r["keep"].to(torch.float32).mean()}
    return y.reshape(B, S, d), aux

