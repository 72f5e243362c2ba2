"""Run configuration of the rAge-k protocol: the port's copy of
``repro.configs.base.RAgeKConfig`` with the same fields, defaults and
construction-time validation."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RAgeKConfig:
    """Hyper-parameters of the paper's protocol (Alg. 1/2 + §III-B)."""

    r: int = 75                      # magnitude pre-selection size
    k: int = 10                      # requested indices per round
    H: int = 4                       # local steps per global round
    M: int = 20                      # clustering cadence (global rounds)
    eps: float = 0.3                 # DBSCAN eps on 1 - similarity
    min_pts: int = 2                 # DBSCAN minPts
    lr: float = 1e-4                 # Adam lr (paper)
    batch_size: int = 256
    method: str = "rage_k"           # rage_k | rtop_k | top_k | random_k | dense | cafe
    disjoint_in_cluster: bool = True # PS requests disjoint sets within a cluster
    wire_dtype: str = "float32"      # paper: fp32 values; bf16 = beyond-paper
    cafe_lam: float = 0.1            # CAFe cost weight (method == "cafe")
    candidates: str = "threshold"    # top-r report: 'threshold' | 'sort'
    schedule: str = "full"           # participation plane
    participation_m: int = 0         # 0 -> max(N // 4, 1) (uniform/aoi)
    deadline_s: float = 0.0          # 0 -> 1.0 simulated s (deadline)
    buffer_k: int = 0                # async service: 0 -> N
    staleness_eta: float = 0.5
    version_window: int = 1
    age_layout: str = "dense"        # 'dense' | 'hierarchical'

    _METHODS = ("rage_k", "rtop_k", "top_k", "random_k", "dense", "cafe")
    _CANDIDATES = ("sort", "threshold")
    _SCHEDULES = ("full", "uniform", "aoi", "deadline")
    _WIRE_DTYPES = ("float32", "bfloat16", "float16")
    _AGE_LAYOUTS = ("dense", "hierarchical")

    def __post_init__(self):
        for name, allowed in (("method", self._METHODS),
                              ("candidates", self._CANDIDATES),
                              ("schedule", self._SCHEDULES),
                              ("wire_dtype", self._WIRE_DTYPES),
                              ("age_layout", self._AGE_LAYOUTS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, "
                                 f"got {getattr(self, name)!r}")
        for name in ("r", "k", "H", "M", "batch_size", "min_pts"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        if self.method in ("rage_k", "rtop_k", "cafe") and self.r < self.k:
            raise ValueError(
                f"method {self.method!r} selects k of the top-r "
                f"candidates; need r >= k (got r={self.r}, k={self.k})")
        for name in ("lr", "eps"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0, "
                                 f"got {getattr(self, name)}")
        for name in ("participation_m", "deadline_s", "buffer_k",
                     "staleness_eta"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, "
                                 f"got {getattr(self, name)}")
        if self.version_window < 1:
            raise ValueError(f"version_window must be >= 1, "
                             f"got {self.version_window}")
