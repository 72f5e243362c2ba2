"""The sharding rules engine: the port of ``repro.dist.sharding``.

Models annotate activations and parameters with LOGICAL axis names
("batch", "d_ff", "heads", ...); this module resolves them against the
ACTIVE mesh with per-dim divisibility fallbacks, so that the same model
code runs on (data, model), (pod, data, model) and one-process meshes.
Without an active mesh every annotation is the identity (the port's
single-card and CPU paths).

    with use_mesh(mesh):                      # optionally rules={...}
        x = constraint(x, ("batch", "seq", "embed"))
        specs = param_specs(params)           # tree of PartitionSpec
        placements = named(specs)             # tree of DTensor placements

A mesh is anything with a ``.shape`` dict of axis sizes in mesh order:
:class:`Mesh` over a ``torch.distributed.device_mesh.DeviceMesh`` (its
``device_mesh``), ``launch.mesh.HostMesh``, or a bare :class:`Mesh` with
no device mesh for spec work alone.

Resolution rules (override per ``use_mesh`` via ``rules=``): logical name
-> tuple of mesh axes tried in order. A dim is sharded over the surviving
axes only when (a) they exist in the mesh with a size above 1, (b) none
was used by an earlier dim of the same array, and (c) the dim's size is
divisible by their product. Anything else replicates.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

# logical axis -> mesh axes (order matters: earlier dims claim axes first)
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),          # ZeRO-3 parameter/optimizer sharding
    "model": ("model",),
    "d_ff": ("model",),
    "heads": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "ssm_heads": ("model",),
    "seq_model": ("model",),          # sequence-parallel attention
    "seq": None,                      # replicated unless a rule maps it
    "embed": None,
    None: None,
}

# parameter leaf name -> logical names for the TRAILING dims (leading
# layer-stack / expert-stack dims replicate)
DEFAULT_PARAM_RULES: dict = {
    "wq": ("fsdp", "heads"), "wk": ("fsdp", "heads"), "wv": ("fsdp", "heads"),
    "wo": ("heads", "fsdp"),
    "w1": ("fsdp", "d_ff"), "w3": ("fsdp", "d_ff"), "w2": ("d_ff", "fsdp"),
    "w": ("vocab", "fsdp"),           # embedding / lm_head
    "router": ("fsdp", None),         # n_experts rarely divides any axis
    "experts_w1": ("expert", "fsdp", None),
    "experts_w3": ("expert", "fsdp", None),
    "experts_w2": ("expert", "fsdp", None),
    "in_proj": ("fsdp", "model"), "out_proj": ("model", "fsdp"),
    "w_dkv": ("fsdp", None), "w_kr": ("fsdp", None),
    "w_uk": (None, "fsdp", "heads"), "w_uv": (None, "fsdp", "heads"),
    # 1-D / small leaves (norm scales, biases, conv taps, A_log, D): replicate
}


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), an axis name, or a tuple
    of axis names (the dim split over all of them, the first outermost).
    A tuple of one name is that name and an empty tuple None, as JAX
    normalizes them. A leaf of the port's trees (``repro_torch.tree``),
    not a node."""

    is_tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class Placements(tuple):
    """One DTensor placement a mesh dim: a leaf of the port's trees."""

    is_tree_leaf = True


@dataclass(frozen=True)
class Mesh:
    """``shape``: axis name -> size, in mesh order; ``device_mesh``: the
    ``DeviceMesh`` whose dims carry those names, or None for spec work."""

    shape: dict
    device_mesh: object = field(default=None, compare=False)


def from_device_mesh(device_mesh) -> Mesh:
    """A :class:`Mesh` over ``device_mesh``, named by its dim names."""
    names = device_mesh.mesh_dim_names
    return Mesh(dict(zip(names, device_mesh.shape)), device_mesh)


class _Ctx(threading.local):
    def __init__(self):
        self.stack: list = []


_CTX = _Ctx()


@contextmanager
def use_mesh(mesh, rules: dict | None = None):
    """Activate ``mesh`` (and optional logical-rule overrides) for the
    dynamic extent. ``rules={"fsdp": None}`` turns ZeRO sharding off."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _CTX.stack.append((mesh, merged))
    try:
        yield mesh
    finally:
        _CTX.stack.pop()


def active_mesh():
    """The innermost mesh activated by use_mesh, or None."""
    return _CTX.stack[-1][0] if _CTX.stack else None


def current():
    """(mesh, rules) of the innermost use_mesh, or None."""
    return _CTX.stack[-1] if _CTX.stack else None


def _active_rules() -> dict:
    return _CTX.stack[-1][1] if _CTX.stack else DEFAULT_RULES


def resolve_spec(names: tuple, shape: tuple) -> PartitionSpec:
    """Resolve logical names against the active mesh with divisibility
    fallbacks. names[i] annotates shape[i]; unknown or None names
    replicate."""
    mesh = active_mesh()
    if mesh is None:
        return P(*([None] * len(shape)))
    rules = _active_rules()
    used: set = set()
    out: list = []
    for name, dim in zip(names, shape):
        axes = rules.get(name, None)
        if axes is None:
            out.append(None)
            continue
        cand = tuple(a for a in axes
                     if a in mesh.shape and a not in used and mesh.shape[a] > 1)
        n = 1
        for a in cand:
            n *= mesh.shape[a]
        if n > 1 and dim % n == 0:
            out.append(cand if len(cand) > 1 else cand[0])
            used.update(cand)
        else:
            out.append(None)
    return P(*out)


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``'s dims: ``Shard(dim)`` on
    each mesh dim that an entry names (an entry over two axes shards its
    dim on both, the first outermost, as DTensor orders a dim's shards by
    mesh dim), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh.shape)
    out = [Replicate()] * len(order)
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if [order.index(a) for a in axes] != sorted(order.index(a)
                                                    for a in axes):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {order}")
        for a in axes:
            out[order.index(a)] = Shard(dim)
    return Placements(out)


def _device_mesh(mesh):
    dm = getattr(mesh, "device_mesh", None)
    if dm is None:
        raise RuntimeError(f"mesh {mesh.shape} has no DeviceMesh to place "
                           f"tensors on")
    return dm


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor under an active mesh (the dry run's
    tensors); False without a mesh, where every tensor is local."""
    if active_mesh() is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constraint(x, names: tuple):
    """The counterpart of ``with_sharding_constraint``: a ``DTensor`` is
    redistributed to the placements that ``names`` resolve to under the
    active mesh. Without an active mesh, and on a plain tensor (local
    data, as the manual sync's and one card's are), it is the identity and
    returns ``x`` itself."""
    if not is_dtensor(x):
        return x
    mesh = active_mesh()
    spec = resolve_spec(tuple(names), tuple(x.shape))
    return x.redistribute(x.device_mesh, placements(mesh, spec))


def split_heads(x, shape: tuple):
    """``x.reshape(shape)`` where x's last dim splits into (heads, head
    dim). A DTensor whose last dim is sharded on mesh dims that the head
    count does not divide is first gathered on them: the one activation
    reshard a layer that the reference pays at this reshape when its heads
    do not divide the model axis."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        pl = list(x.placements)
        n = 1
        for md, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim == x.ndim - 1:
                if shape[-2] % (n * x.device_mesh.shape[md]):
                    pl[md] = Replicate()
                else:
                    n *= x.device_mesh.shape[md]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(shape)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def _leaf_spec(name: str, leaf, overrides: dict) -> PartitionSpec:
    logical = overrides.get(name, DEFAULT_PARAM_RULES.get(name))
    shape = tuple(leaf.shape)
    if logical is None:
        if len(shape) >= 2:
            logical = ("fsdp", "model")       # generic matmul weight
        else:
            return P(*([None] * len(shape)))
    # logical names annotate the trailing dims; leading (layer-stack) dims
    # replicate
    pad = len(shape) - len(logical)
    if pad < 0:
        logical = logical[-len(shape):]
        pad = 0
    return resolve_spec((None,) * pad + tuple(logical), shape)


def _map_named(fn, tree, name: str = ""):
    """fn(leaf name, leaf) over a tree of dicts, lists and tuples; the
    leaf name is the last key (an index for a list or tuple)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not getattr(
            tree, "is_tree_leaf", False):
        return type(tree)(_map_named(fn, v, str(i))
                          for i, v in enumerate(tree))
    return fn(name, tree)


def param_specs(params, overrides: dict | None = None):
    """Tree of PartitionSpec matching ``params`` (tensors of any device,
    ``meta`` ones included). ``overrides``: leaf name -> logical names for
    the trailing dims."""
    ov = overrides or {}
    return _map_named(lambda name, leaf: _leaf_spec(name, leaf, ov), params)


def map_leaves(fn, tree):
    """fn(leaf name, leaf) over every leaf of ``tree`` (PartitionSpecs
    are leaves): the cache rules read the leaf's name, as the
    reference's ``tree_map_with_path`` does."""
    return _map_named(fn, tree)


def named(specs):
    """PartitionSpec tree -> tree of DTensor placement tuples on the
    active mesh's DeviceMesh."""
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError("named() requires an active mesh (use_mesh)")
    _device_mesh(mesh)
    return _map_named(lambda _n, s: placements(mesh, s), specs)


def mesh_coords(mesh, rank: int) -> dict:
    """Axis name -> this rank's coordinate on a row-major mesh (the last
    axis fastest, as ``jax.make_mesh`` and ``init_device_mesh`` lay it)."""
    out = {}
    for a in reversed(list(mesh.shape)):
        out[a] = rank % mesh.shape[a]
        rank //= mesh.shape[a]
    return {a: out[a] for a in mesh.shape}


def local_slice(x, spec, mesh, coords: dict):
    """The slice of the global ``x`` that the device at ``coords`` (axis
    name -> coordinate) holds under ``spec``: each dim cut in equal
    blocks over its entry's axes, the first axis outermost."""
    idx = []
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        n, j = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            j = j * mesh.shape[a] + coords[a]
        size = x.shape[dim] // n
        idx.append(slice(j * size, (j + 1) * size))
    return x[tuple(idx)]


def shard_count(mesh, spec) -> int:
    """The number of distinct slices of a leaf under ``spec``."""
    n = 1
    for entry in spec:
        for a in spec_axes(entry):
            n *= mesh.shape.get(a, 1)
    return n
