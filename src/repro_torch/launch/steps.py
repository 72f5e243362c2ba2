"""Step builders and the sharding specs of the production meshes: the
port of ``repro.launch.steps``.

``make_train_step``, ``make_prefill_step`` and ``make_decode_step`` run
every family of ``models.transformer`` (dense, MoE, SSM, hybrid, VLM,
audio): the SSM and hybrid decode steps write their conv and SSM states
into the cache in place, as every family writes its K/V rows; a batch is
any dict of tensors with the batch on its leading axis
(``models.registry.input_specs``), so the VLM's embeddings and audio's
frames split into microbatches as tokens do.

The spec helpers (``batch_spec_tree``, ``cache_spec_tree``,
``attention_overrides``, ``param_sharding``, ``opt_sharding``) derive
specs from the rules engine in ``dist.sharding`` with per-dim
divisibility fallbacks, so the same code serves (data, model), (pod,
data, model) and one-process meshes. ``lower_combo`` assembles one
(arch x shape x mesh) step for the dry run (``launch.dryrun``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch import tree as _tree
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.dist import regions as RG
from repro_torch.dist import sharding as SH
from repro_torch.dist.sharding import PartitionSpec as P
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import OptState, adam, apply_updates


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _div(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def batch_spec_tree(mesh, specs: dict, cfg: ArchConfig) -> dict:
    """Input batch specs: the batch dim over (pod, data) when divisible."""
    ba = batch_axes(mesh)
    nb = _axes_size(mesh, ba)

    def spec(s):
        if len(s.shape) >= 1 and _div(s.shape[0], nb):
            return P(ba)
        return P()
    return {k: spec(v) for k, v in specs.items()}


def cache_spec_tree(mesh, cfg: ArchConfig, cache_shapes) -> Any:
    """KV, latent and state cache specs (the leading dim is n_layers or
    the hybrid's applications).

    Greedy: B over (pod, data) when divisible, KV heads over model when
    divisible, then any UNUSED axes on the cache's sequence dim (decode
    attention contracts over S with a combined softmax, so S-sharding is
    always legal). long_500k (B 1) ends with S over all axes; decode_32k
    with B over data and S or heads over model.
    """
    ba = batch_axes(mesh)
    nb = _axes_size(mesh, ba)
    nm = mesh.shape.get("model", 1)
    kv_names = ("k", "v", "cross_k", "cross_v", "c_kv", "k_rope")

    def leaf_spec(name, leaf):
        s = leaf.shape
        out = [None] * len(s)
        used: list = []
        if len(s) >= 2 and _div(s[1], nb):
            out[1] = ba
            used.extend(ba)
        if name in kv_names:
            if len(s) == 5 and _div(s[3], nm):
                out[3] = "model"
                used.append("model")
            free = tuple(a for a in mesh.shape if a not in used)
            if free and len(s) >= 3 and _div(s[2], _axes_size(mesh, free)):
                out[2] = free if len(free) > 1 else free[0]
        elif name == "state" and len(s) == 5 and _div(s[2], nm):
            out[2] = "model"          # (L, B, nh, hp, ns): heads over model
        elif name == "conv" and len(s) == 4 and _div(s[3], nm):
            out[3] = "model"
        return P(*out)

    return SH.map_leaves(leaf_spec, cache_shapes)


def abstract_params(cfg: ArchConfig):
    """The parameter tree as ``meta`` tensors: ``transformer.init`` run
    under a fake tensor mode (no storage, no draws), its shapes and
    dtypes carried to ``meta``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = T.init(cfg, torch.Generator(), device="cpu")
    return _tree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def attention_overrides(mesh, cfg: ArchConfig) -> dict:
    """Config-aware sharding decisions the path rules cannot make alone.

    Attention is head-sharded over 'model' only when both n_heads and
    n_kv_heads divide the model axis; for tp > G, the Megatron GQA
    practice replicates the KV projections and shards the Q heads and
    the row-parallel out projection. MLA replicates its small latent and
    rope projections' outputs and shards the head up-projections.
    """
    nm = mesh.shape.get("model", 1)
    if cfg.n_heads == 0:
        return {}
    if cfg.use_mla:
        return {"w_dkv": ("fsdp", None), "w_kr": ("fsdp", None)}
    if cfg.n_heads % nm == 0:
        if cfg.n_kv_heads % nm == 0:
            return {}
        return {"wk": ("fsdp", None), "wv": ("fsdp", None)}
    return {}


def param_sharding(mesh, cfg: ArchConfig, params_shape=None):
    """The parameters' DTensor placements on ``mesh``'s DeviceMesh."""
    if params_shape is None:
        params_shape = abstract_params(cfg)
    with SH.use_mesh(mesh):
        specs = SH.param_specs(params_shape,
                               overrides=attention_overrides(mesh, cfg))
        return SH.named(specs)


def opt_sharding(mesh, param_shardings):
    """OptState(step, mu, nu) placed like the params (ZeRO-3 style), the
    step replicated."""
    return OptState(SH.placements(mesh, P()), param_shardings,
                    param_shardings)


def make_train_step(cfg: ArchConfig, shape: InputShape, *, lr: float = 1e-4,
                    sync=None):
    """Returns train_step(params, opt_state, batch[, ages]) -> (params,
    opt, loss[, ages, stats]).

    ``cfg.grad_accum[shape.name]`` microbatches (the batch's leading axis
    cut in that many) have their gradients summed in float32 and divided
    by their count, and their losses averaged; the optimizer is Adam
    (float32 moments). With ``sync`` (a ``make_manual_sync`` closure) the
    gradients go through that exchange over its data group before the
    update."""
    opt = adam(lr)
    accum = cfg.grad_accum.get(shape.name, 1)

    def loss(params, batch):
        return T.loss_fn(params, cfg, batch)

    def _grads(params, batch):
        if accum == 1:
            (value, _aux), grads = _tree.value_and_grad(loss, params, batch,
                                                       has_aux=True)
            return grads, value
        micro = {k: (RG.microbatches(v, accum) if SH.is_dtensor(v) else
                     v.reshape((accum, v.shape[0] // accum) + v.shape[1:]))
                 for k, v in batch.items()}
        gsum = _tree.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        losses = []
        for i in range(accum):
            (value, _aux), g = _tree.value_and_grad(
                loss, params, {k: v[i] for k, v in micro.items()},
                has_aux=True)
            gsum = _tree.tree_map(lambda a, b: a + b.to(torch.float32),
                                  gsum, g)
            losses.append(value)
        grads = _tree.tree_map(lambda g: g / accum, gsum)
        return grads, torch.stack(losses).mean()

    if sync is None:
        def train_step(params, opt_state, batch):
            grads, value = _grads(params, batch)
            updates, opt_state = opt.update(grads, opt_state, params)
            return apply_updates(params, updates), opt_state, value
        return train_step

    def train_step_sync(params, opt_state, batch, ages):
        grads, value = _grads(params, batch)
        synced, new_ages, stats = sync(grads, ages)
        del grads
        updates, opt_state = opt.update(synced, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, value, new_ages, stats

    return train_step_sync


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def serve_step(params, inputs, cache, pos):
        return T.decode_step(params, cfg, inputs, cache, pos)
    return serve_step


# ---------------------------------------------------------------------------
# dry-run assembly: one (arch x shape x mesh) step on abstract inputs
# ---------------------------------------------------------------------------


@dataclass
class Lowered:
    """One step ready to run on fake tensors: ``fn(*args)`` where ``args``
    are trees of ``meta`` tensors of the global shapes (or host ints) and
    ``placements`` the matching trees of DTensor placements on ``mesh``'s
    DeviceMesh (None for a host int). ``donate``: the argument positions
    that the step's outputs replace (the memory count's aliases)."""

    fn: Callable
    args: tuple
    placements: tuple
    mesh: Any
    kind: str
    donate: tuple = ()


def _local_sync(sync, mesh, grad_placements, age_placements):
    """The manual sync on DTensors: each leaf's local slice through
    ``sync`` (which gathers over the data group alone), the results put
    back on the mesh under the params' placements. A gradient is first
    placed as its parameter on the model axis (its data axes as autograd
    left them: a partial sum there is this shard's own gradient)."""
    from torch.distributed.tensor import DTensor

    dm = mesh.device_mesh
    data = [a in ("pod", "data") for a in mesh.shape]

    def local_grad(t, pl):
        want = tuple(tp if d else p for tp, p, d in zip(t.placements, pl,
                                                        data))
        if want != tuple(t.placements):
            t = t.redistribute(dm, want)
        return t.to_local()

    def run(grads, ages):
        g_l = _tree.tree_map(local_grad, grads, grad_placements)
        a_l = _tree.tree_map(lambda t: t.to_local(), ages)
        synced, new_ages, stats = sync(g_l, a_l)
        synced = _tree.tree_map(
            lambda t, pl, ref: DTensor.from_local(
                t, dm, pl, run_check=False, shape=ref.shape,
                stride=ref.stride()), synced, grad_placements, grads)
        new_ages = _tree.tree_map(
            lambda t, pl, ref: DTensor.from_local(
                t, dm, pl, run_check=False, shape=ref.shape,
                stride=ref.stride()), new_ages, age_placements, ages)
        return synced, new_ages, stats
    return run


def lower_combo(cfg: ArchConfig, shape: InputShape, mesh, *, lr=1e-4,
                sync: str = "auto", sync_r_frac: float = 1 / 256,
                sync_k_frac: float = 1 / 2048):
    """Returns (Lowered, kind) for one (arch x shape x mesh) combination:
    the step and its abstract arguments with their placements. Nothing is
    allocated: the arguments are ``meta`` tensors.

    sync: 'auto' (the gradient reduction that DTensor infers, ZeRO-3 over
    data), 'dense' (the explicit bfloat16 mean over the data group;
    params replicated over data, model-sharded only), or 'rage_k' (the
    paper's sparse exchange, each shard selecting from its local slice).
    Train shapes only take the last two.
    """
    # long-context variant: dense/moe/vlm archs get a sliding window
    if (shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm")
            and not cfg.sliding_window):
        cfg = cfg.replace(sliding_window=8192)
    # prefill: sequence-parallel attention for non-divisible-head archs
    if shape.kind == "prefill":
        cfg = cfg.replace(seq_parallel_attn=True)

    pshape = abstract_params(cfg)
    rules = {"fsdp": None} if sync != "auto" else None
    with SH.use_mesh(mesh, rules=rules):
        pspecs = SH.param_specs(pshape,
                                overrides=attention_overrides(mesh, cfg))
        pshard = SH.named(pspecs)

    def in_mesh(fn):
        def run(*args):
            with SH.use_mesh(mesh, rules=rules):
                return fn(*args)
        return run

    with SH.use_mesh(mesh, rules=rules):
        if shape.kind == "train":
            specs = R.input_specs(cfg, shape)
            bshard = SH.named(batch_spec_tree(mesh, specs, cfg))
            oshard = opt_sharding(mesh, pshard)
            opt_shape = OptState(
                torch.zeros((), dtype=torch.int32, device="meta"),
                _tree.tree_map(lambda p: torch.empty(
                    p.shape, dtype=torch.float32, device="meta"), pshape),
                _tree.tree_map(lambda p: torch.empty(
                    p.shape, dtype=torch.float32, device="meta"), pshape))
            if sync != "auto":
                from repro_torch.dist.sparse_sync import (
                    init_age_state_sharded, make_manual_sync)
                total = sum(math.prod(l.shape) for l in _tree.leaves(pshape))
                sync_fn = make_manual_sync(
                    mesh, pspecs, pshape, method=sync,
                    r=max(1, int(total * sync_r_frac)),
                    k=max(1, int(total * sync_k_frac)))
                age_shape = init_age_state_sharded(pshape, method=sync,
                                                   device="meta")
                ashard = SH.named(sync_fn.age_specs)
                step = make_train_step(
                    cfg, shape, lr=lr,
                    sync=_local_sync(sync_fn, mesh, pshard, ashard))
                return Lowered(in_mesh(step),
                               (pshape, opt_shape, specs, age_shape),
                               (pshard, oshard, bshard, ashard), mesh,
                               "train", (0, 1, 3)), "train"
            step = make_train_step(cfg, shape, lr=lr)
            return Lowered(in_mesh(step), (pshape, opt_shape, specs),
                           (pshard, oshard, bshard), mesh, "train",
                           (0, 1)), "train"
        if shape.kind == "prefill":
            specs = R.input_specs(cfg, shape)
            bshard = SH.named(batch_spec_tree(mesh, specs, cfg))
            return Lowered(in_mesh(make_prefill_step(cfg)), (pshape, specs),
                           (pshard, bshard), mesh, "prefill"), "prefill"
        inputs, cache_shape = R.decode_input_specs(cfg, shape)
        cshard = SH.named(cache_spec_tree(mesh, cfg, cache_shape))
        ishard = SH.named(batch_spec_tree(mesh, inputs, cfg))
        return Lowered(in_mesh(make_decode_step(cfg)),
                       (pshape, inputs, cache_shape, shape.seq_len - 1),
                       (pshard, ishard, cshard, None), mesh, "decode",
                       (2,)), "decode"
