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

Tokens are routed in blocks aligned with the batch axes of the active
mesh (``dist.sharding.use_mesh``), each block against its own capacity
C = capacity(cfg, T / n_blocks), as the reference cuts them
(``_n_token_blocks``); without a mesh, or when a block would hold fewer
than 256 tokens, there is one block. Dispatch and combine are plain
PyTorch, as they are jnp outside any Pallas kernel in the reference.
They add no float atomics: every kept (block, expert, row) triple
receives exactly one token's row, and the dropped ones go to a spare row
that nothing reads. On DTensors (the dry run) each block is routed on
its own data shard (``_moe_sharded``).
"""
from __future__ import annotations

import torch

from repro_torch.dist import sharding as SH
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


def _n_token_blocks(T: int) -> int:
    """Token blocks aligned with the batch axes of the active mesh."""
    mesh = SH.active_mesh()
    if mesh is None:
        return 1
    nb = 1
    for a in ("pod", "data"):
        nb *= mesh.shape.get(a, 1)
    # tiny workloads (decode) must not block: the per-block capacity floor
    # times n_experts times n_blocks over-allocates the dispatch buffers
    if nb <= 1 or T % nb or T // nb < 256:
        return 1
    return nb


def _position_in_expert(flat_ids: torch.Tensor, E: int) -> torch.Tensor:
    """Exclusive rank of each assignment within its expert and block, in
    flat (token, slot) order: flat_ids (nb, TK) -> (nb, TK), or one block
    (TK,) -> (TK,). One cumsum of
    the one-hot, laid out (nb, E, TK) so that the scan runs along
    contiguous memory (a scan down the outer axis of (TK, E) took 1.5 ms a
    layer at granite's 8,192 x 40 on the H100). The reference's chunked
    prefix sum exists for GSPMD; the integers are the same."""
    ids = flat_ids[None] if flat_ids.ndim == 1 else flat_ids
    oh = (torch.arange(E, device=ids.device)[None, :, None]
          == ids[:, None, :]).to(torch.int32)
    before = torch.cumsum(oh, dim=2, dtype=torch.int32) - oh
    pos = before.gather(1, ids[:, None, :])[:, 0]
    return pos[0] if flat_ids.ndim == 1 else pos


def route(router: torch.Tensor, cfg, xt: torch.Tensor) -> dict:
    """Routing of nb blocks of Tb tokens xt (nb, Tb, d), or of one block
    (Tb, d) without the leading axis: float32 ``logits`` (nb, Tb, E),
    ``gates`` (nb, Tb, K) float32, expert ``ids`` (nb, Tb, K), each
    assignment's ``pos`` in its expert and block and ``keep`` (pos < C),
    (nb, Tb * K), and a block's capacity ``C``."""
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = xt.to(torch.float32) @ router
    gate_k, ids = top_k(logits, K)
    pos = _position_in_expert(ids.reshape(*ids.shape[:-2], -1), E)
    C = capacity(cfg, xt.shape[-2])
    return dict(logits=logits, gates=torch.softmax(gate_k, dim=-1), ids=ids,
                pos=pos, keep=pos < C, C=C)


def _dispatch_combine(p: dict, cfg, xt: torch.Tensor, r: dict,
                      e0: int = 0) -> torch.Tensor:
    """The routed experts' output (nb, Tb, d) for the blocks xt (nb, Tb, d)
    routed by ``r``. ``p``'s expert stacks hold experts e0 .. e0 + E_l - 1
    (all E of them off the dry run); assignments to other experts add 0
    here."""
    nb, Tb, d = xt.shape
    K = cfg.experts_per_token
    E = p["experts_w1"].shape[0]
    C = r["C"]
    e = r["ids"].reshape(nb, Tb * K) - e0
    keep = r["keep"] & (e >= 0) & (e < E)
    # each kept assignment's row of the (nb * E * C + 1, d) buffer; the
    # dropped ones share the spare last row, which nothing reads
    blk = torch.arange(nb, device=xt.device)[:, None] * (E * C)
    slot = torch.where(keep, blk + e * C + r["pos"], nb * E * C).reshape(-1)
    xe = xt[:, :, None, :].expand(nb, Tb, K, d).reshape(nb * Tb * K, d)
    buf = xt.new_zeros((nb * E * C + 1, d)).index_copy(0, slot, xe)
    buf = buf[:nb * E * C].reshape(nb, E, C, d).transpose(0, 1).reshape(
        E, nb * C, d)

    # bfloat16 products summed in float32 and cast back, on the card's
    # cuBLAS and the CPU's BLAS alike: the reference's TPU artifact
    a = L.act_fn(cfg.act)
    h = a(torch.bmm(buf, p["experts_w1"])) * torch.bmm(buf, p["experts_w3"])
    out = torch.bmm(h, p["experts_w2"]).reshape(E, nb, C, d).transpose(
        0, 1).reshape(nb * E * C, d)
    out = torch.cat([out, out.new_zeros((1, d))])      # the spare row: 0
    # index_select: its backward adds into the spare row's many repeats
    # at once, where indexing's sorts and walks them one by one
    y = out.index_select(0, slot).reshape(nb, Tb, K, d) * r["gates"][
        ..., None].to(xt.dtype)
    return y.sum(dim=2)


def apply_moe(p: dict, cfg, x: torch.Tensor):
    """x: (B, S, d) -> (y (B, S, d), aux) with aux = {"lb_loss" (the
    Switch load-balance loss E * sum(mean softmax * top-1 share) over all
    T tokens), "drop_frac" (the dropped share of the T * K
    assignments)}, float32 0-d tensors."""
    B, S, d = x.shape
    T = B * S
    E = cfg.n_experts
    nb = _n_token_blocks(T)
    if SH.is_dtensor(x):
        y, aux = _moe_sharded(p, cfg, x, nb)
    else:
        xt = x.reshape(nb, T // nb, d)
        r = route(p["router"], cfg, xt)
        y = _dispatch_combine(p, cfg, xt, r).reshape(B, S, d)
        me = torch.softmax(r["logits"].reshape(T, E), dim=-1).mean(dim=0)
        ce = torch.nn.functional.one_hot(r["ids"].reshape(T, -1)[:, 0],
                                         E).to(torch.float32).mean(dim=0)
        aux = {"lb_loss": E * torch.sum(me * ce),
               "drop_frac": 1.0 - r["keep"].to(torch.float32).mean()}
    if cfg.n_shared_experts:
        y = y + L.apply_mlp(p["shared"], cfg, x)
    return y, aux


def _moe_sharded(p: dict, cfg, x, nb: int):
    """``apply_moe``'s routed part on DTensors x (B, S, d): each data shard
    routes and dispatches its own rows as its block (all rows as one block
    when there is one, or when the blocks do not fall on whole rows, the
    tokens gathered), and each model shard runs its slice of the experts
    where E divides the model axis, its output a partial sum over model;
    the load-balance terms are partial sums over the batch axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = SH.active_mesh()
    dm = x.device_mesh
    names = list(mesh.shape)
    B, S, d = x.shape
    T = B * S
    E = cfg.n_experts
    w_pl = p["experts_w1"].placements
    ep = "model" in names and w_pl[names.index("model")] == Shard(0)
    blocked = nb > 1 and B % nb == 0
    batch = [a in ("pod", "data") and blocked for a in names]
    x_pl = tuple(Shard(0) if b else Replicate() for b in batch)
    w_in = tuple(Shard(0) if (a == "model" and ep) else Replicate()
                 for a in names)
    y_pl = tuple(Shard(0) if b else (Partial() if a == "model" and ep
                                     else Replicate())
                 for a, b in zip(names, batch))
    sums = tuple(Partial() if b else Replicate() for b in batch)
    e_l = E // mesh.shape["model"] if ep else E
    e0 = dm.get_local_rank("model") * e_l if ep else 0

    def local(router, w1, w3, w2, xl):
        xl3 = xl.reshape(1, -1, d)
        r = route(router, cfg, xl3)
        y = _dispatch_combine({"experts_w1": w1, "experts_w3": w3,
                               "experts_w2": w2}, cfg, xl3, r,
                              e0).reshape(xl.shape)
        me = torch.softmax(r["logits"], dim=-1).sum(dim=(0, 1))
        ce = torch.nn.functional.one_hot(r["ids"][..., 0], E).to(
            torch.float32).sum(dim=(0, 1))
        kept = r["keep"].to(torch.float32).sum()
        return y, me, ce, kept

    y, me, ce, kept = local_map(
        local, out_placements=(y_pl, sums, sums, sums),
        in_placements=(tuple(Replicate() for _ in names), w_in, w_in, w_in,
                       x_pl), redistribute_inputs=True, device_mesh=dm)(
        p["router"], p["experts_w1"], p["experts_w3"], p["experts_w2"], x)
    K = cfg.experts_per_token
    me, ce = me / T, ce / T
    aux = {"lb_loss": E * torch.sum(me * ce), "drop_frac": 1.0 - kept / (T * K)}
    return y, aux

