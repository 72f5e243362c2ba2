"""Sparse (rAge-k) gradient synchronization, the paper's protocol as a
data-parallel collective: the port of ``repro.dist.sparse_sync``.

The age state is a tree of int32 tensors shaped like the parameters: one
age per coordinate, each leaf a bucket with its share of the global (r,
k) budget (``core.sparsify.bucket_budgets``, leaves in
``jax.tree_util`` order). Selection per bucket goes through the same
``core.strategies`` classes as the FL engine, so with
``candidates='threshold'`` each bucket's top-r report is the CUDA report
(``maghist_batch``'s counts and ``threshold_topk_batch``) on the card.

Three entry points:

``make_sync_train_step``  one program: the gradient is replaced by its
    wire form (:func:`sync_grads`) before the optimizer.
``make_manual_sync``      the explicit exchange over a
    ``torch.distributed`` data group (``launch.mesh.make_host_mesh``):
    each rank selects its k_b entries per bucket from its own gradient,
    all-gathers (idx, vals) in rank order, and lands the union through
    ``kernels.ops.sparse_aggregate`` (the CUDA kernel on the card): the
    scatter-add of vals / n_active with the hit-based age lane. Under
    model-sharded specs (``dist.sharding``) each rank passes its local
    slice of every leaf, the bucket's (r_b, k_b) is split across the
    leaf's shards, and the exchange gathers over the data group alone,
    as the reference's ``shard_map`` does.
``make_buffered_sync``    FedBuff-style buffering over the manual sync.

Byte counts are host ints, exact at any size: the reference stores the
per-shard count as an int32 and overflows on a dense full-width
internlm2-1.8b wire of 3,399,684,096 B (ROADMAP queue 3, fault 7); the
two agree wherever the reference's fits.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch import tree as _tree
from repro_torch.core.sparsify import bucket_budgets
from repro_torch.core.strategies import make_strategy
from repro_torch.device import resolve
from repro_torch.dist import sharding as SH
from repro_torch.kernels import ops
from repro_torch.optim.optimizers import apply_updates

# Indices go on the wire as int32, so that IS this collective's payload
# (the protocol accounting's ceil(log2(d) / 8) bytes an index is
# core.compression's, not this exchange's).
_INDEX_BYTES = 4
METHODS = ("rage_k", "cafe", "top_k", "dense")


def init_age_state(params, *, method: str = "rage_k"):
    """Age tree: int32 zeros shaped like every parameter leaf, on its
    device. For ``method='cafe'`` each leaf gains a leading (2,) axis:
    row 0 the ages, row 1 the cumulative upload-cost counter. Under the
    manual sync's union semantics this is one (d,) row for the whole data
    group (the engine's cluster-keyed layout at C = 1)."""
    return _tree.tree_map(lambda p: _zero_ages(p, method, p.device), params)


def age_state_bytes(ages) -> int:
    """Device bytes of an age tree: O(d) (x2 for CAFe) whatever the
    number of data shards."""
    return sum(a.numel() * a.element_size() for a in _tree.leaves(ages))


def init_age_state_sharded(shapes, *, method: str = "rage_k", device=None):
    """:func:`init_age_state` from a tree of shapes (tensors of any device,
    ``meta`` ones included, the port's ``ShapeDtypeStruct``), on
    ``device`` (None means the card)."""
    dev = resolve(device)
    return _tree.tree_map(lambda s: _zero_ages(s, method, dev), shapes)


def _zero_ages(like, method: str, device):
    """One age leaf: int32 zeros of ``like``'s shape, with the leading
    (2,) [age; cost] axis for 'cafe'."""
    lead = (2,) if method == "cafe" else ()
    return torch.zeros(lead + tuple(like.shape), dtype=torch.int32,
                       device=device)


def _wire_bytes(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _check_method(method: str):
    if method not in METHODS:
        raise ValueError(
            f"sparse_sync supports 'rage_k' | 'cafe' | 'top_k' | 'dense', "
            f"got {method!r} (stochastic baselines need per-step "
            f"generators; use the FL engine)")


def _select_bucket(method: str, flat, age_flat, r_b: int, k_b: int,
                   lam: float = 0.1, candidates: str = "sort"):
    """One bucket's selection through the Strategy API: (idx (k_b,) int32,
    vals (k_b,), new ages). For 'cafe' ``age_flat`` is the stacked
    (2, d_b) [age; cost] state; 'top_k' leaves the ages as they are."""
    d_b = flat.shape[0]
    r_b, k_b = min(r_b, d_b), min(k_b, d_b)
    strat = make_strategy(method, r=r_b, k=k_b, lam=lam,
                          candidates=candidates)
    if method == "rage_k":
        return strat.select(flat, age_flat)
    if method == "cafe":
        idx, vals, (na, nc) = strat.select(flat, (age_flat[0], age_flat[1]))
        return idx, vals, torch.stack([na, nc])
    idx, vals, _ = strat.select(flat, ())
    return idx, vals, age_flat


def _flat_age(a, method: str):
    """Bucket view of one age leaf: (d_b,), or (2, d_b) for cafe."""
    return a.reshape(2, -1) if method == "cafe" else a.reshape(-1)


# ---------------------------------------------------------------------------
# one program
# ---------------------------------------------------------------------------


def sync_grads(grads, ages, *, method: str = "rage_k", r: int = 0,
               k: int = 0, wire_dtype=torch.bfloat16, lam: float = 0.1,
               candidates: str = "sort"):
    """Gradient to wire and back, one program: grads and ages in,
    (synced grads, new ages, stats) out. dense: each leaf through a
    ``wire_dtype`` round trip; sparse: the k_b selected entries of each
    bucket, rounded through ``wire_dtype``, zero elsewhere, and the ages
    updated by eq. (2) (cafe also counts the picks into its cost lane;
    top_k leaves the ages). stats["wire_bytes_per_shard"] (a host int)
    counts k_b (4 B index + a wire value) a bucket, or every value
    dense."""
    _check_method(method)
    leaves, node = _tree.flatten(grads)
    age_leaves = _tree.leaves(ages)
    sizes = [l.numel() for l in leaves]
    vb = _wire_bytes(wire_dtype)
    if method == "dense":
        synced = [l.to(wire_dtype).to(l.dtype) for l in leaves]
        new_ages = age_leaves
        wire = sum(sizes) * vb
    else:
        synced, new_ages, wire = [], [], 0
        for l, a, (r_b, k_b) in zip(leaves, age_leaves,
                                    bucket_budgets(sizes, r, k)):
            flat = l.reshape(-1)
            idx, vals, new_a = _select_bucket(
                method, flat, _flat_age(a, method), r_b, k_b, lam=lam,
                candidates=candidates)
            vals = vals.to(wire_dtype).to(flat.dtype)
            synced.append(torch.zeros_like(flat).scatter(
                0, idx.to(torch.int64), vals).reshape(l.shape))
            new_ages.append(new_a.reshape(a.shape))
            wire += min(k_b, flat.shape[0]) * (_INDEX_BYTES + vb)
    return (_tree.unflatten(node, synced), _tree.unflatten(node, new_ages),
            {"wire_bytes_per_shard": wire})


def make_sync_train_step(loss_fn, opt, mesh=None, *, method: str = "rage_k",
                         r: int = 0, k: int = 0, wire_dtype=torch.bfloat16,
                         lam: float = 0.1, candidates: str = "sort"):
    """Returns step(params, opt_state, ages, batch) -> (params, opt_state,
    ages, loss, stats): ``loss_fn(params, batch)``'s gradient by autograd,
    through :func:`sync_grads`, then ``opt``'s update. ``mesh`` is kept
    for the reference's signature; one program needs none."""
    del mesh
    _check_method(method)

    def step(params, opt_state, ages, batch):
        loss, grads = _tree.value_and_grad(loss_fn, params, batch)
        synced, new_ages, stats = sync_grads(
            grads, ages, method=method, r=r, k=k, wire_dtype=wire_dtype,
            lam=lam, candidates=candidates)
        del grads
        updates, opt_state = opt.update(synced, opt_state, params)
        del synced
        params = apply_updates(params, updates)
        return params, opt_state, new_ages, loss, stats

    return step


# ---------------------------------------------------------------------------
# the explicit exchange over a torch.distributed group
# ---------------------------------------------------------------------------


def _data_group(mesh, data_axes: tuple, n_data: int):
    """(the data axes' process group, this rank's coordinate in it): the
    mesh's own (``HostMesh``), or, on a ``dist.sharding.Mesh`` over a
    DeviceMesh (the dry run's), a group of the ranks that share this
    rank's other coordinates."""
    if hasattr(mesh, "group"):
        return mesh.group, mesh.rank
    dm = mesh.device_mesh
    if dm is None or n_data == 1:
        return None, 0
    coords = SH.mesh_coords(mesh, dist.get_rank())
    ranks = [q for q in range(math.prod(mesh.shape.values()))
             if all(SH.mesh_coords(mesh, q)[a] == c
                    for a, c in coords.items() if a not in data_axes)]
    rank = 0
    for a in data_axes:
        rank = rank * mesh.shape[a] + coords[a]
    return dist.new_group(ranks), rank


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n * len(t),) in rank order, as the reference's tiled gather."""
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.cat(out)


def make_manual_sync(mesh, specs, shapes, *, method: str = "rage_k",
                     candidates: str = "sort", r: int = 0, k: int = 0,
                     wire_dtype=torch.bfloat16, lam: float = 0.1,
                     validate: bool = False, gate_bound: float = 1e4):
    """The explicit exchange over ``mesh``'s data axes (``make_host_mesh``,
    or a ``dist.sharding.Mesh`` over a DeviceMesh). ``specs`` None: every
    leaf replicated; else a tree of ``dist.sharding.PartitionSpec`` (the
    params'), under which each rank passes the local slice of every leaf
    and age leaf (``dist.sharding.local_slice`` at its coordinates) and
    gets its local slices back. ``shapes``: a tree of tensors (``meta``
    ones will do) of the global shapes. Returns sync(grads, ages,
    active=None) -> (synced, new_ages, stats), with ``.n_data`` and
    ``.age_specs`` (the grads' specs; for cafe the leading [age; cost]
    lane replicated).

    Each leaf's global (r_b, k_b) is split across its ns shards, so that
    the whole replica group uploads k_b entries: r_l = max(1, r_b // ns),
    k_l = max(1, min(r_l, k_b // ns if k_b >= ns else 1)), selected from
    the local slice. No collective runs over the model axis.

    Each rank selects its k_b entries per bucket from its own gradient,
    all-gathers (idx int32, vals in ``wire_dtype``) over the group in rank
    order, and lands the union: the scatter-add of vals / n_act and the
    hit-based age lane (0 where any rank requested, else age + 1; for
    every non-cafe method, top_k too), which is ``sparse_aggregate``'s
    contract; cafe's cost lane adds the union's hits. dense: a
    ``wire_dtype`` round trip, then the group's sum over n_data (n_act
    under a mask or the gate).

    ``active`` ((n_data,) bool): an inactive rank sends sentinel indices
    (d_b, dropped) and zero values, and the union divides by the active
    count. ``validate``: a rank whose gradient holds a non-finite value or
    max |g| > ``gate_bound`` is quarantined like an inactive one, but is
    billed: stats ``wire_bytes_per_shard`` (a host int), ``active_shards``
    (the ranks that landed), ``wire_bytes_total`` (the per-shard bytes
    times the senders, quarantined ones included) and
    ``quarantined_shards``, int64 tensors on the grads' device.
    """
    _check_method(method)
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    n_data = math.prod(mesh.shape[a] for a in data_axes)
    group, rank = _data_group(mesh, data_axes, n_data)
    sizes = [math.prod(s.shape) for s in _tree.leaves(shapes)]
    spec_leaves = (_tree.leaves(specs) if specs is not None
                   else [SH.P()] * len(sizes))
    if method != "dense":
        budgets = []
        for (r_b, k_b), spec in zip(bucket_budgets(sizes, r, k),
                                    spec_leaves):
            ns = SH.shard_count(mesh, spec)
            r_l = max(1, r_b // ns)
            k_l = max(1, min(r_l, k_b // ns if k_b >= ns else 1))
            budgets.append((r_l, k_l))
    else:
        budgets = [(0, 0)] * len(sizes)
    vb = _wire_bytes(wire_dtype)

    def sync(grads, ages, active=None):
        g_leaves, node = _tree.flatten(grads)
        age_leaves = _tree.leaves(ages)
        dev = g_leaves[0].device

        def count(n):
            return torch.tensor(n, dtype=torch.int64, device=dev)

        my = None
        n_senders = count(n_data)
        if active is not None:
            active = torch.as_tensor(active, dtype=torch.bool, device=dev)
            if tuple(active.shape) != (n_data,):
                raise ValueError(
                    f"active mask must have shape ({n_data},), one bit per "
                    f"data shard, got {tuple(active.shape)}")
            my = active[rank]
            n_senders = active.sum()
        n_quar = count(0)
        n_uploaders = n_senders
        if validate:
            ok = torch.ones((), dtype=torch.bool, device=dev)
            for g in g_leaves:
                fg = g.reshape(-1).to(torch.float32)
                ok = (ok & torch.isfinite(fg).all()
                      & (fg.abs().max() <= gate_bound))
            my = ok if my is None else my & ok
            n_uploaders = my.to(torch.int64)
            if group is not None:
                dist.all_reduce(n_uploaders, group=group)
            n_quar = n_senders - n_uploaders
        n_act = (n_uploaders.clamp(min=1).to(torch.float32)
                 if my is not None else n_data)
        synced, new_ages, wire = [], [], 0
        for g, a, (r_b, k_b) in zip(g_leaves, age_leaves, budgets):
            flat = g.reshape(-1).to(torch.float32)
            d_b = flat.shape[0]
            if method == "dense":
                w = flat.to(wire_dtype).to(torch.float32)
                if my is not None:
                    w = torch.where(my, w, 0.0)
                if group is not None:
                    # the sum lands in place: never in the caller's grads
                    w = w.clone() if w is flat else w
                    dist.all_reduce(w, group=group)
                synced.append((w / n_act).reshape(g.shape).to(g.dtype))
                new_ages.append(a)
                wire += d_b * vb
                continue
            af = _flat_age(a, method)
            idx, vals, _ = _select_bucket(method, flat, af, r_b, k_b,
                                          lam=lam, candidates=candidates)
            vals = vals.to(wire_dtype)
            if my is not None:
                idx = torch.where(my, idx, d_b)
                vals = torch.where(my, vals, torch.zeros_like(vals))
            if group is not None:
                idx = _all_gather(idx, group, n_data)
                vals = _all_gather(vals, group, n_data)
            lane = af[0] if method == "cafe" else af
            dense, new_lane = ops.sparse_aggregate(
                idx, vals.to(torch.float32) / n_act, lane)
            if method == "cafe":
                new_a = torch.stack([new_lane,
                                     af[1] + (new_lane == 0).to(af.dtype)])
            else:
                new_a = new_lane
            synced.append(dense.reshape(g.shape).to(g.dtype))
            new_ages.append(new_a.reshape(a.shape))
            wire += min(k_b, d_b) * (_INDEX_BYTES + vb)
        stats = {"wire_bytes_per_shard": wire,
                 "active_shards": n_uploaders,
                 "wire_bytes_total": wire * n_senders,
                 "quarantined_shards": n_quar}
        return (_tree.unflatten(node, synced),
                _tree.unflatten(node, new_ages), stats)

    sync.n_data = n_data
    # ages lie like the grads (cafe: the leading lane replicated)
    sync.age_specs = specs
    if method == "cafe" and specs is not None:
        sync.age_specs = _tree.tree_map(lambda s: SH.P(None, *s), specs)
    return sync


# ---------------------------------------------------------------------------
# buffered (FedBuff-style) union
# ---------------------------------------------------------------------------


class BufferState:
    """The carried accumulator of :func:`make_buffered_sync`: ``sums`` a
    tree of float32 running sums of landed updates, ``count`` a 0-d int64
    count of the shard-updates they hold."""

    __slots__ = ("sums", "count")

    def __init__(self, sums, count):
        self.sums = sums
        self.count = count


def make_buffered_sync(mesh, specs, shapes, *, buffer_k: int,
                       method: str = "rage_k", candidates: str = "sort",
                       r: int = 0, k: int = 0, wire_dtype=torch.bfloat16,
                       lam: float = 0.1, validate: bool = False,
                       gate_bound: float = 1e4):
    """FedBuff-style buffering over :func:`make_manual_sync`: each call
    lands its active ranks' union into a running buffer of sums (scaled
    back by the active count) and releases their mean once ``buffer_k``
    shard-updates are in (``count >= buffer_k``), zeros before. Ages
    advance with every call's union, as in the base sync. Returns
    sync(grads, ages, buf, active=None) -> (synced, new_ages, new_buf,
    stats); stats add ``flushed`` and ``buffered_shards`` (after the
    call, 0 after a flush); ``.init_buffer()`` gives the empty buffer on
    the mesh's device."""
    if buffer_k < 1:
        raise ValueError(f"buffer_k must be >= 1, got {buffer_k}")
    base = make_manual_sync(mesh, specs, shapes, method=method,
                            candidates=candidates, r=r, k=k,
                            wire_dtype=wire_dtype, lam=lam,
                            validate=validate, gate_bound=gate_bound)

    def init_buffer() -> BufferState:
        sums = _tree.tree_map(
            lambda s: torch.zeros(tuple(s.shape), dtype=torch.float32,
                                  device=mesh.device), shapes)
        return BufferState(sums, torch.zeros((), dtype=torch.int64,
                                             device=mesh.device))

    def sync(grads, ages, buf: BufferState, active=None):
        synced, new_ages, stats = base(grads, ages, active=active)
        n_act = stats["active_shards"]
        sums = _tree.tree_map(
            lambda b, s: b + s.to(torch.float32) * n_act.to(torch.float32),
            buf.sums, synced)
        count = buf.count + n_act
        flush = count >= buffer_k
        denom = count.clamp(min=1).to(torch.float32)
        out = _tree.tree_map(
            lambda s, g: torch.where(flush, (s / denom).to(g.dtype),
                                     torch.zeros_like(g)), sums, synced)
        new_sums = _tree.tree_map(
            lambda s: torch.where(flush, torch.zeros_like(s), s), sums)
        new_count = torch.where(flush, torch.zeros_like(count), count)
        stats = dict(stats, flushed=flush, buffered_shards=new_count)
        return out, new_ages, BufferState(new_sums, new_count), stats

    sync.n_data = base.n_data
    sync.age_specs = base.age_specs
    sync.init_buffer = init_buffer
    return sync
