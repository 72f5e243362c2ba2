"""Model registry: the API of the LM zoo behind one record and the input
specs, the port of ``repro.models.registry``: ``ModelFns`` and
``get_model``; ``input_specs`` and ``decode_input_specs``, which describe
a step's inputs as tensors on the ``meta`` device (shapes and dtypes, no
storage: PyTorch's counterpart of a ``ShapeDtypeStruct``); and
``concrete_batch``, a batch of those shapes drawn from a generator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class ModelFns:
    init: Callable               # (cfg, generator, device) -> params
    loss_fn: Callable            # (params, cfg, batch) -> (loss, aux)
    prefill: Callable            # (params, cfg, inputs) -> last logits
    decode_step: Callable        # (params, cfg, inputs, cache, pos) -> (logits, cache)
    init_cache: Callable         # (cfg, batch, max_len, device) -> cache


def get_model(cfg: ArchConfig) -> ModelFns:
    """The zoo's functions for every LM family (dense, MoE with GQA or MLA
    attention, SSM, hybrid, VLM, audio); the paper's nets are refused
    (see ``transformer.require_lm``)."""
    T.require_lm(cfg)
    return ModelFns(T.init, T.loss_fn, T.prefill, T.decode_step,
                    T.init_cache)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=getattr(torch, str(dtype)),
                       device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """A (train | prefill) step's inputs as ``meta`` tensors. audio: the
    stub conv frontend's frame embeddings (B, seq / frontend_downsample,
    d) and the decoder's tokens (B, max_target_len); vlm: the stub ViT's
    embeddings (B, seq, d); the others tokens (B, seq). Labels (int32, the
    tokens' shape) for a train step."""
    B, S = shape.global_batch, shape.seq_len
    dt = cfg.dtype
    if cfg.family == "audio":
        Td = cfg.max_target_len
        spec = {"frames": _spec((B, S // cfg.frontend_downsample,
                                 cfg.d_model), dt),
                "tokens": _spec((B, Td), "int32")}
        if shape.kind == "train":
            spec["labels"] = _spec((B, Td), "int32")
        return spec
    if cfg.family == "vlm":
        spec = {"embeds": _spec((B, S, cfg.d_model), dt)}
    else:
        spec = {"tokens": _spec((B, S), "int32")}
    if shape.kind == "train":
        spec["labels"] = _spec((B, S), "int32")
    return spec


def decode_input_specs(cfg: ArchConfig, shape: InputShape) -> tuple:
    """(inputs, cache) of a decode step as ``meta`` tensors: the VLM's
    ``embed`` (B, d), else ``token`` (B,) int32; the cache of
    ``init_cache(cfg, B, seq)``."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        inputs = {"embed": _spec((B, cfg.d_model), cfg.dtype)}
    else:
        inputs = {"token": _spec((B,), "int32")}
    return inputs, T.init_cache(cfg, B, S, device="meta")


def concrete_batch(cfg: ArchConfig, shape: InputShape,
                   generator: torch.Generator, device=None) -> dict:
    """A batch matching ``input_specs`` drawn from ``generator`` (on
    ``device``, None meaning the card), spec by spec in its order: ints
    uniform in [0, vocab_size), floats standard normal drawn in float32
    and cast to the spec's dtype. JAX's draws differ; the semantics are
    the reference's."""
    dev = resolve(device)
    out = {}
    for name, s in input_specs(cfg, shape).items():
        if s.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, s.shape,
                                      generator=generator, device=dev,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(s.shape, generator=generator,
                                    device=dev).to(s.dtype)
    return out
