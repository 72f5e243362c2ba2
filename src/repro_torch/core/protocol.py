"""The parameter-server protocol (paper Algorithm 1 glue): the port's
numpy copy of ``repro.core.protocol``.

One global round:
  1. every client reports its top-r magnitude candidate indices,
  2. the PS picks the k highest-age indices per client from its cluster's
     age vector — with DISJOINT sets across clients of the same cluster
     (the merged vector coordinates exploration, §II),
  3. clients upload the k (value, index) pairs; the PS aggregates and
     applies eq. (2) to the cluster ages + frequency vectors,
  4. every M rounds: eq. (3) similarity -> DBSCAN -> cluster update.

The device math (top-k, scatter-add) lives in core.sparsify and the
kernels; this module is the host-side control plane, in numpy. Its
``select_indices`` is the stable-argsort oracle that the engine's
selection (``fl.engine.rage_select`` and the segmented plane) is held
to.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import RAgeKConfig
from repro_torch.core.age import AgeState
from repro_torch.core.clustering import cluster_clients


@dataclass
class Round:
    requested: dict          # client -> (k,) np.ndarray of requested indices


class ParameterServer:
    """Host-side PS: owns ages, frequencies, clusters."""

    def __init__(self, d: int, n_clients: int, hp: RAgeKConfig):
        self.d = d
        self.n = n_clients
        self.hp = hp
        self.age = AgeState(d, n_clients)
        self.round_idx = 0

    # ------------------------------------------------------------------
    def select_indices(self, candidates: dict) -> Round:
        """candidates: client -> (r,) candidate indices ordered by |g| desc.

        Implements step 2 with in-cluster disjointness: clients of one
        cluster are processed in order; indices already taken this round
        are excluded for the rest of the cluster.
        """
        hp = self.hp
        requested: dict = {}
        taken: dict = {}                     # cluster -> set of indices
        for i in range(self.n):
            cand = np.asarray(candidates[i])
            cl = int(self.age.cluster_of[i])
            ages = self.age.age_of(i)[cand].astype(np.int64)
            if hp.disjoint_in_cluster and cl in taken and taken[cl]:
                excl = np.fromiter(taken[cl], dtype=np.int64)
                ages = np.where(np.isin(cand, excl), -1, ages)
            # stable top-k by age; ties favor larger |g| (cand is |g|-sorted)
            order = np.argsort(-ages, kind="stable")[: hp.k]
            idx = cand[order]
            requested[i] = idx
            taken.setdefault(cl, set()).update(idx.tolist())
        return Round(requested=requested)

    # ------------------------------------------------------------------
    def finish_round(self, rnd: Round):
        """Apply eq. (2) + frequency updates, run clustering every M."""
        for i, idx in rnd.requested.items():
            self.age.record_request(i, np.asarray(idx))
        self.round_idx += 1
        if self.round_idx % self.hp.M == 0:
            labels = cluster_clients(self.age.freq, self.hp.eps, self.hp.min_pts)
            self.age.apply_clusters(labels)
        return self.age.cluster_of.copy()
