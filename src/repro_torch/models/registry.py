"""Model registry: the API of the LM zoo behind one record, the port of
``repro.models.registry.ModelFns`` and ``get_model``.

The dry-run's input specs are not ported yet (ROADMAP queue 1, item
16.9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.models import transformer as T


@dataclass(frozen=True)
class ModelFns:
    init: Callable               # (cfg, generator, device) -> params
    loss_fn: Callable            # (params, cfg, batch) -> (loss, aux)
    prefill: Callable            # (params, cfg, inputs) -> last logits
    decode_step: Callable        # (params, cfg, inputs, cache, pos) -> (logits, cache)
    init_cache: Callable         # (cfg, batch, max_len, device) -> cache


def get_model(cfg) -> ModelFns:
    """The decoder's functions for the dense and MoE families (GQA or MLA
    attention), the SSM family and the hybrid one; the VLM and audio
    families raise (see ``transformer.require_ported``)."""
    T.require_ported(cfg)
    return ModelFns(T.init, T.loss_fn, T.prefill, T.decode_step,
                    T.init_cache)
