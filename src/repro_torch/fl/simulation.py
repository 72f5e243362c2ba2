"""The compatibility entry point over :mod:`repro_torch.fl.engine`: the
port of ``repro.fl.simulation``.

``run_fl`` keeps the original end-to-end signature (paper Algorithm 1 on
the paper's two models with the paper's non-i.i.d. splits); the round
loop is ``FederatedEngine``'s. New code builds the engine directly::

    from repro_torch.fl import FederatedEngine
    engine = FederatedEngine("mlp", shards, test, hp, seed=0)
    res = engine.run(rounds=200, eval_every=5)
"""
from __future__ import annotations

from repro_torch.configs.base import RAgeKConfig
from repro_torch.fl.engine import (  # noqa: F401  (re-exported)
    DeviceAgeState, FederatedEngine, FLResult, _build_model,
)


def run_fl(kind: str, shards: list, test: tuple, hp: RAgeKConfig, *,
           rounds: int, eval_every: int = 5, heatmap_at: tuple = (),
           seed: int = 0, ef: bool = False, global_opt: str = "adam",
           verbose: bool = False, device=None) -> FLResult:
    """shards: [(x_i, y_i)] per client. test: (x_test, y_test).
    ``rounds`` counts global iterations (each hp.H local steps).
    ``device=None`` means the card, and raises without one."""
    engine = FederatedEngine(kind, shards, test, hp, seed=seed, ef=ef,
                             global_opt=global_opt, device=device)
    return engine.run(rounds, eval_every=eval_every, heatmap_at=heatmap_at,
                      verbose=verbose)
