"""Local regions of the model on DTensors: where DTensor's sharding
propagation has no rule for what the model does, the region runs on each
device's local shards under ``torch.distributed.tensor.experimental.
local_map`` with placements chosen here, and its outputs come back as
DTensors. Only the dry run (``launch.dryrun``) hands the model DTensors;
on plain tensors none of this runs.

* :func:`matmul_mode`: ``x @ w`` of an activation (B, S, ..., d) by a
  weight (d, f) whose leading dims are sharded on two mesh dims at once
  (batch over data, sequence over model): DTensor flattens them into a
  strided shard that its ``mm`` rule refuses. The mode computes such a
  product per device: the weight gathered on each mesh dim where the
  activation holds a leading-dim shard, a contraction shard on both
  sides giving a partial sum.
* :func:`flash_attention`: batch shards, head shards (the KV heads of a
  device's query heads sliced out where G does not divide the model
  axis) and sequence shards of q (its offset added).
* :func:`decode_attention`: batch, head and cache-position shards; a
  position shard's partial softmax is combined across its mesh dims as
  split-KV decode combines its splits.
* :func:`ssd`: the SSD chunk scan, batch and head shards.
* :func:`merge_heads`: MLA's decode context (B, H, hd) into the output
  projection, its heads sharded on more than one mesh dim.
"""
from __future__ import annotations

import math

import torch


def _local_rank(dm, md: int) -> int:
    return dm.get_local_rank(md)


def _local(fn, in_pl, out_pl, dm, *args):
    """``fn`` on the local shards of ``args`` placed as ``in_pl``; its
    output (one, or a tuple) placed as ``out_pl`` (a tuple of placements,
    or a tuple of those). An input replicated on a mesh dim that shards
    another input gets its gradient there as a partial sum: each shard of
    the work holds its own share of it."""
    from torch.distributed.tensor import Partial, Placement, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if out_pl and isinstance(out_pl[0], Placement):
        out_pl = list(out_pl)      # one output: its placements as a list
    split = [any(isinstance(pl[md], Shard) for pl in in_pl)
             for md in range(dm.ndim)]
    grad_pl = tuple(tuple(Partial() if isinstance(p, Replicate) and s
                          else p for p, s in zip(pl, split))
                    for pl in in_pl)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, redistribute_inputs=True,
                     device_mesh=dm)(*args)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def _matmul(x, w):
    """x (..., d) @ w (d, f) on DTensors, placed per mesh dim: a leading
    shard of x keeps it (w gathered there), a column shard of w shards the
    output's last dim, a contraction shard on both gives a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    dm = x.device_mesh
    last = x.ndim - 1
    x_in, w_in, out = [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(xp, Shard) and xp.dim < last:
            x_in.append(xp)
            w_in.append(Replicate())
            out.append(xp)
        elif isinstance(wp, Shard) and wp.dim == 1:
            x_in.append(Replicate())
            w_in.append(wp)
            out.append(Shard(last))
        elif (isinstance(wp, Shard) and wp.dim == 0) or (
                isinstance(xp, Shard) and xp.dim == last):
            x_in.append(Shard(last))
            w_in.append(Shard(0))
            out.append(Partial())
        else:
            x_in.append(Replicate())
            w_in.append(Replicate())
            out.append(Replicate())
    return _local(torch.matmul, (tuple(x_in), tuple(w_in)), tuple(out), dm,
                  x, w)


def merge_heads(o, w):
    """``o.reshape(B, 1, H * hd) @ w`` of a decode step's context o (B, H,
    hd) and the output projection w (H * hd, d), on local shards: per
    mesh dim, o's batch shard keeps it (w gathered there), its head shard
    meets w's rows cut the same way (a partial sum), its partial sum stays
    one; anything else replicates. (Merging heads sharded on two mesh dims
    leaves a strided shard that DTensor cannot redistribute.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard

    dm = o.device_mesh
    o_in, w_in, out = [], [], []
    for op in o.placements:
        if isinstance(op, Shard) and op.dim == 0:
            o_in.append(op), w_in.append(Replicate()), out.append(op)
        elif isinstance(op, Shard) and op.dim == 1:
            o_in.append(op), w_in.append(Shard(0)), out.append(Partial())
        elif isinstance(op, Partial):
            o_in.append(op), w_in.append(Replicate()), out.append(op)
        else:
            o_in.append(Replicate()), w_in.append(Replicate())
            out.append(Replicate())
    return _local(lambda ol, wl: ol.reshape(ol.shape[0], 1, -1) @ wl,
                  (tuple(o_in), tuple(w_in)), tuple(out), dm, o, w)


def preserve(fn):
    """``fn`` run under the sharding context and :func:`matmul_mode` that
    are active now: a checkpoint's recompute runs outside the caller's
    modes, and would take other shards than its forward. ``fn`` itself
    without an active mesh."""
    from repro_torch.dist import sharding as SH

    ctx = SH.current()
    if ctx is None:
        return fn

    def run(*args):
        with SH.use_mesh(*ctx), matmul_mode():
            return fn(*args)
    return run


def matmul_mode():
    """A ``TorchFunctionMode`` that sends ``x @ w`` (x a DTensor of 3 or
    more dims, w a 2-D DTensor) through :func:`_matmul`."""
    from torch.distributed.tensor import DTensor
    from torch.overrides import TorchFunctionMode

    ops = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__}

    class _Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if (func in ops and len(args) == 2 and not kwargs
                    and isinstance(args[0], DTensor)
                    and isinstance(args[1], DTensor)
                    and args[0].ndim >= 3 and args[1].ndim == 2):
                return _matmul(*args)
            return func(*args, **kwargs)

    return _Mode()


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _head_slice(H: int, G: int, n: int, j: int):
    """The KV heads that query heads [j * H/n, (j+1) * H/n) read: (start,
    count)."""
    rep = H // G
    h_l = H // n
    if h_l % rep == 0:
        return j * h_l // rep, h_l // rep
    return (j * h_l) // rep, 1


def flash_attention(fn, q, k, v, *, causal, window, q_offset, kv_chunk):
    """``fn`` (the plain flash attention) on local shards of q (B, Sq, H,
    D) and k/v (B, Skv, G, D): per mesh dim, q's batch shard shards all
    three, its head shard shards q (and k/v where G divides, else each
    device slices its query heads' KV heads), its sequence shard shards q
    alone (the offset of its block added); anything else replicates."""
    from torch.distributed.tensor import Replicate, Shard

    dm = q.device_mesh
    H, G = q.shape[2], k.shape[2]
    Sq = q.shape[1]
    q_in, kv_in = [], []
    seq_dims, head_dim = [], None
    for md, qp in enumerate(q.placements):
        if isinstance(qp, Shard) and qp.dim == 0:
            q_in.append(qp)
            kv_in.append(qp)
        elif isinstance(qp, Shard) and qp.dim == 2 and head_dim is None:
            n = dm.shape[md]
            q_in.append(qp)
            kv_in.append(Shard(2) if G % n == 0 else Replicate())
            head_dim = md
        elif isinstance(qp, Shard) and qp.dim == 1:
            q_in.append(qp)
            kv_in.append(Replicate())
            seq_dims.append(md)
        else:
            q_in.append(Replicate())
            kv_in.append(Replicate())
    slice_kv = (head_dim is not None
                and isinstance(kv_in[head_dim], Replicate))
    off = q_offset
    n_seq = 1
    for md in seq_dims:
        n_seq *= dm.shape[md]
    j_seq = 0
    for md in seq_dims:
        j_seq = j_seq * dm.shape[md] + _local_rank(dm, md)
    off += j_seq * (Sq // n_seq)
    if slice_kv:
        g0, g_n = _head_slice(H, G, dm.shape[head_dim],
                              _local_rank(dm, head_dim))

    def local(ql, kl, vl):
        if slice_kv:
            kl, vl = kl[:, :, g0:g0 + g_n], vl[:, :, g0:g0 + g_n]
        return fn(ql, kl, vl, causal=causal, window=window, q_offset=off,
                  kv_chunk=kv_chunk)

    return _local(local, (tuple(q_in), tuple(kv_in), tuple(kv_in)),
                  tuple(q_in), dm, q, k, v)


def _decode_partial(q, k, v, n: int):
    """One device's split: (o (B, H, D) float32 normalized over its n
    positions, lse (B, H) float32), -inf where it holds none."""
    B, H, D = q.shape
    G = k.shape[2]
    rep = H // G
    kf = k[:, :n].repeat_interleave(rep, dim=2).to(torch.float32)
    vf = v[:, :n].repeat_interleave(rep, dim=2).to(torch.float32)
    s = torch.einsum("bhd,bshd->bhs", q.to(torch.float32) * D ** -0.5, kf)
    m = s.amax(-1, keepdim=True) if n else torch.full(
        (B, H, 1), -math.inf, device=q.device)
    p = torch.exp(s - m)
    lse = (m[..., 0] + torch.log(p.sum(-1))) if n else m[..., 0]
    o = torch.einsum("bhs,bshd->bhd", p, vf) / p.sum(-1, keepdim=True).clamp(
        min=1e-30)
    return o, lse


def decode_attention(fn, q, k, v, cache_len):
    """``fn`` (the decode attention wrapper) on local shards of q (B, H,
    D) and the (B, S, G, D) caches, placed by the cache: its batch shard
    shards q too, its KV-head shard shards q's heads; where it shards the
    positions, each device attends over its block (its share of
    ``cache_len``) and the blocks' partial softmaxes are combined
    across those mesh dims by their log-sum-exp."""
    from torch.distributed.tensor import Replicate, Shard

    dm = k.device_mesh
    S = k.shape[1]
    q_in, kv_in, s_dims = [], [], []
    for md, kp in enumerate(k.placements):
        if isinstance(kp, Shard) and kp.dim == 0:
            q_in.append(Shard(0))
            kv_in.append(kp)
        elif isinstance(kp, Shard) and kp.dim == 2:
            q_in.append(Shard(1))
            kv_in.append(kp)
        elif isinstance(kp, Shard) and kp.dim == 1:
            q_in.append(Replicate())
            kv_in.append(kp)
            s_dims.append(md)
        else:
            q_in.append(Replicate())
            kv_in.append(Replicate())
    if not s_dims:
        return _local(lambda ql, kl, vl: fn(ql, kl, vl, cache_len),
                      (tuple(q_in), tuple(kv_in), tuple(kv_in)),
                      tuple(q_in), dm, q, k, v)
    n_s, j = 1, 0
    for md in s_dims:
        n_s *= dm.shape[md]
        j = j * dm.shape[md] + _local_rank(dm, md)
    block = S // n_s
    n_l = max(0, min(min(cache_len, S) - j * block, block))
    out_pl = tuple(Shard(0) if md in s_dims else
                   (Shard(p.dim + 1) if isinstance(p, Shard) else p)
                   for md, p in enumerate(q_in))
    lse_pl = tuple(Shard(0) if md in s_dims else
                   (Shard(p.dim + 1) if isinstance(p, Shard) else p)
                   for md, p in enumerate(q_in))

    def local(ql, kl, vl):
        o, lse = _decode_partial(ql, kl, vl, n_l)
        return o[None], lse[None]

    o, lse = _local(local, (tuple(q_in), tuple(kv_in), tuple(kv_in)),
                    (out_pl, lse_pl), dm, q, k, v)
    w = torch.softmax(lse, dim=0)
    return (o * w[..., None]).sum(0).to(q.dtype)


# ---------------------------------------------------------------------------
# the SSD chunk scan
# ---------------------------------------------------------------------------


def ssd(fn, x, dtA, B, C, chunk, init_state):
    """``fn`` (``models.ssm.ssd_chunked``) on local shards: x (b, L, h, p)
    and dtA (b, L, h) sharded by batch and heads as x is, B and C (b, L,
    n) by batch alone, the state (b, h, p, n) as x's heads."""
    from torch.distributed.tensor import Replicate, Shard

    dm = x.device_mesh
    x_in, a_in, bc_in, s_in = [], [], [], []
    for xp in x.placements:
        if isinstance(xp, Shard) and xp.dim == 0:
            x_in.append(xp), a_in.append(xp), bc_in.append(xp)
            s_in.append(xp)
        elif isinstance(xp, Shard) and xp.dim == 2:
            x_in.append(xp), a_in.append(Shard(2)), bc_in.append(Replicate())
            s_in.append(Shard(1))
        else:
            for lst in (x_in, a_in, bc_in, s_in):
                lst.append(Replicate())
    args = [x, dtA, B, C]
    in_pl = [tuple(x_in), tuple(a_in), tuple(bc_in), tuple(bc_in)]
    if init_state is not None:
        args.append(init_state)
        in_pl.append(tuple(s_in))

    def local(*a):
        return fn(*a[:4], chunk, init_state=a[4] if len(a) > 4 else None)

    return _local(local, tuple(in_pl), (tuple(x_in), tuple(s_in)), dm,
                  *args)


# ---------------------------------------------------------------------------
# cross entropy over vocabulary shards
# ---------------------------------------------------------------------------


def xent(logits, labels):
    """(logsumexp over the vocabulary, the label's logit) of logits (B, c,
    V) and labels (B, c), on local shards: each vocabulary shard's
    log-sum-exp, stacked and combined, and its share of the label's
    logit, a partial sum. (DTensor's ``gather`` on a vocabulary shard
    leaves a masked partial that its later index ops cannot reduce.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard

    dm = logits.device_mesh
    last = logits.ndim - 1
    V = logits.shape[-1]
    l_in, lab_in, lse_out, gold_out, v_dims = [], [], [], [], []
    for md, p in enumerate(logits.placements):
        if isinstance(p, Shard) and p.dim < last:
            l_in.append(p), lab_in.append(p)
            lse_out.append(Shard(p.dim + 1)), gold_out.append(p)
        elif isinstance(p, Shard) and p.dim == last:
            l_in.append(p), lab_in.append(Replicate())
            lse_out.append(Shard(0)), gold_out.append(Partial())
            v_dims.append(md)
        else:
            for lst in (l_in, lab_in, lse_out, gold_out):
                lst.append(Replicate())
    n, j = 1, 0
    for md in v_dims:
        n *= dm.shape[md]
        j = j * dm.shape[md] + _local_rank(dm, md)
    v_l = V // n
    off = j * v_l

    def local(lg, lb):
        idx = lb.to(torch.int64) - off
        inside = (idx >= 0) & (idx < v_l)
        g = lg.gather(-1, idx.clamp(0, v_l - 1)[..., None])[..., 0]
        return (torch.logsumexp(lg, dim=-1)[None],
                torch.where(inside, g, torch.zeros_like(g)))

    lse, gold = _local(local, (tuple(l_in), tuple(lab_in)),
                       (tuple(lse_out), tuple(gold_out)), dm, logits, labels)
    return torch.logsumexp(lse, dim=0), gold


# ---------------------------------------------------------------------------
# microbatches
# ---------------------------------------------------------------------------


def microbatches(v, accum: int):
    """v (B, ...) -> (accum, B / accum, ...): each device cuts its own
    rows into ``accum`` microbatches, so microbatch i holds rows of every
    batch shard. (The plain path's contiguous cut would move rows across
    shards; the sum over the microbatches' mean gradients is the same.)"""
    from torch.distributed.tensor import Shard

    pl = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
               for p in v.placements)
    return _local(lambda t: t.reshape((accum, t.shape[0] // accum)
                                      + tuple(t.shape[1:])),
                  (tuple(v.placements),), pl, v.device_mesh, v)


# ---------------------------------------------------------------------------
# embedding lookups
# ---------------------------------------------------------------------------


def embed(w, ids):
    """w[ids] for a (V, d) table and integer ids, on local shards: each
    vocabulary shard looks up the ids it holds (0 elsewhere), a partial
    sum over those mesh dims; the ids keep their batch shards; where the
    ids are whole on a mesh dim that splits d, each shard looks up its
    columns and the rows, not the table, are gathered. (DTensor's own
    rule goes through an ``index_put`` backward that some torch versions
    cannot place.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard

    dm = w.device_mesh
    ids_pl = ids.placements if hasattr(ids, "placements") else \
        tuple(Replicate() for _ in w.placements)
    w_in, id_in, out, v_dims = [], [], [], []
    for md, (wp, ip) in enumerate(zip(w.placements, ids_pl)):
        if isinstance(wp, Shard) and wp.dim == 0:
            w_in.append(wp), id_in.append(Replicate()), out.append(Partial())
            v_dims.append(md)
        elif isinstance(ip, Shard):
            w_in.append(Replicate()), id_in.append(ip), out.append(ip)
        elif isinstance(wp, Shard):
            w_in.append(wp), id_in.append(Replicate())
            out.append(Shard(ids.ndim))
        else:
            w_in.append(Replicate()), id_in.append(Replicate())
            out.append(Replicate())
    n, j = 1, 0
    for md in v_dims:
        n *= dm.shape[md]
        j = j * dm.shape[md] + _local_rank(dm, md)
    v_l = w.shape[0] // n
    off = j * v_l

    def local(wl, il):
        idx = il.to(torch.int64) - off
        inside = (idx >= 0) & (idx < v_l)
        rows = wl[idx.clamp(0, v_l - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    rows = _local(local, (tuple(w_in), tuple(id_in)), tuple(out), dm, w,
                  ids)
    # the partial sum reduced, and the columns gathered, here, where the
    # reference's gather does both, not carried into the residual stream
    return rows.redistribute(dm, tuple(
        Replicate() if isinstance(p, Partial) or p == Shard(ids.ndim)
        else p for p in rows.placements))


def pad(x, pads):
    """``F.pad(x, pads)`` with zeros on local shards, the padded dims
    unsharded (DTensor's own pad rule fails in some torch versions)."""
    return _local(lambda t: torch.nn.functional.pad(t, pads),
                  (tuple(x.placements),), tuple(x.placements),
                  x.device_mesh, x)


# ---------------------------------------------------------------------------
# layer stacks
# ---------------------------------------------------------------------------


def unbind(v):
    """``v.unbind(0)`` of a stacked leaf whose leading dim may be sharded:
    gathered on those mesh dims first, since DTensor refuses to unbind a
    sharded dim (its select gathers the whole stack once a layer)."""
    from torch.distributed.tensor import Replicate, Shard

    pl = [Replicate() if isinstance(p, Shard) and p.dim == 0 else p
          for p in v.placements]
    if pl != list(v.placements):
        v = v.redistribute(v.device_mesh, pl)
    return v.unbind(0)


# ---------------------------------------------------------------------------
# cache writes
# ---------------------------------------------------------------------------


def write_slot(cache, slot: int, row):
    """``cache[:, slot] = row`` for a (B, S, ...) cache on local shards:
    the device whose block of S holds ``slot`` writes its shard of the row
    in place; the others write nothing. (DTensor's own ``index_put`` on an
    S-sharded cache gathers the whole cache first.)"""
    from torch.distributed.tensor import Replicate, Shard

    dm = cache.device_mesh
    row_pl, s_dims = [], []
    for md, p in enumerate(cache.placements):
        if isinstance(p, Shard) and p.dim == 1:
            row_pl.append(Replicate())
            s_dims.append(md)
        elif isinstance(p, Shard) and p.dim > 1:
            row_pl.append(Shard(p.dim - 1))
        else:
            row_pl.append(p)
    n, j = 1, 0
    for md in s_dims:
        n *= dm.shape[md]
        j = j * dm.shape[md] + _local_rank(dm, md)
    block = cache.shape[1] // n
    start = j * block

    def local(c, r):
        if start <= slot < start + block:
            c[:, slot - start] = r
        return c

    _local(local, (tuple(cache.placements), tuple(row_pl)),
           tuple(cache.placements), dm, cache, row)
