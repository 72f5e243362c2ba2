"""Model registry: the serving API of the LM zoo behind one record, the
port of ``repro.models.registry.ModelFns`` and ``get_model``.

Training (``loss_fn``) and the dry-run's input specs are not ported yet
(ROADMAP queue 1, items 16.8 and 16.9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.models import transformer as T


@dataclass(frozen=True)
class ModelFns:
    init: Callable               # (cfg, generator, device) -> params
    prefill: Callable            # (params, cfg, inputs) -> last logits
    decode_step: Callable        # (params, cfg, inputs, cache, pos) -> (logits, cache)
    init_cache: Callable         # (cfg, batch, max_len, device) -> cache


def get_model(cfg) -> ModelFns:
    """The dense decoder's functions; other families raise (see
    ``transformer.require_ported``)."""
    T.require_ported(cfg)
    return ModelFns(T.init, T.prefill, T.decode_step, T.init_cache)
