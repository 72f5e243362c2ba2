"""Step builders: the port of ``repro.launch.steps``'s ``make_train_step``,
``make_prefill_step`` and ``make_decode_step``, for every family of
``models.transformer`` (dense, MoE, SSM, hybrid, VLM, audio): the SSM and
hybrid decode steps write their conv and SSM states into the cache in
place, as every family writes its K/V rows; a batch is any dict of
tensors with the batch on its leading axis (``models.registry.
input_specs``), so the VLM's embeddings and audio's frames split into
microbatches as tokens do.

The sharding-spec helpers of the reference (``batch_spec_tree``,
``cache_spec_tree``, ``param_sharding``, ``opt_sharding``) and the
dry-run's ``lower_combo`` come with ROADMAP queue 1, item 16.9.
"""
from __future__ import annotations

import torch

from repro_torch import tree as _tree
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import adam, apply_updates


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
        micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
        gsum = _tree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
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
