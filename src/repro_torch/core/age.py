"""Host age-vector state at the parameter server (paper §II, eq. 2): the
port's numpy copy of ``repro.core.age.AgeState``.

The PS keeps one d-dimensional int32 age vector per cluster. When DBSCAN
merges clients, their age vectors merge (elementwise min by default:
the freshest information of any member wins); a client moved to a
different cluster gets a reset vector. The engine's recluster pulls the
device rows down (:meth:`AgeState.from_cluster_rows`), applies the
merge/reset here, and uploads the result.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class AgeState:
    d: int
    n_clients: int
    merge: str = "min"
    cluster_of: np.ndarray = field(init=False)
    ages: dict = field(init=False)          # cluster id -> (d,) int32
    freq: np.ndarray = field(init=False)    # (N, d) eq.-(3) inputs

    def __post_init__(self):
        self.cluster_of = np.arange(self.n_clients)
        self.ages = {i: np.zeros(self.d, np.int32) for i in range(self.n_clients)}
        self.freq = np.zeros((self.n_clients, self.d), np.int64)

    @classmethod
    def from_cluster_rows(cls, cluster_age: np.ndarray,
                          cluster_of: np.ndarray,
                          merge: str = "min") -> "AgeState":
        """Rebuild from pulled rows: row c of ``cluster_age`` is cluster
        c's age vector; only ids present in ``cluster_of`` are live."""
        st = cls(int(cluster_age.shape[1]), int(cluster_of.shape[0]),
                 merge=merge)
        st.cluster_of = cluster_of.astype(np.int64)
        st.ages = {int(c): cluster_age[int(c)].copy()
                   for c in np.unique(st.cluster_of)}
        return st

    def age_of(self, client: int) -> np.ndarray:
        return self.ages[int(self.cluster_of[client])]

    def record_request(self, client: int, idx: np.ndarray):
        """eq. (2) + frequency bookkeeping after requesting `idx`."""
        a = self.ages[int(self.cluster_of[client])]
        a += 1
        a[idx] = 0
        self.freq[client, idx] += 1

    def apply_clusters(self, labels: np.ndarray):
        """labels: (N,) DBSCAN ids (noise = unique singleton). Joining an
        existing cluster merges age vectors; changing cluster identity
        resets the vector."""
        labels = self._canonicalize(labels)
        new_ages: dict = {}
        for cl in np.unique(labels):
            members = set(np.where(labels == cl)[0].tolist())
            # previous clusters fully absorbed into this one keep history
            prev = {int(self.cluster_of[m]) for m in members}
            vecs = []
            for p in prev:
                old_members = set(np.where(self.cluster_of == p)[0].tolist())
                if old_members <= members:
                    vecs.append(self.ages[p])
            if vecs:
                op = np.minimum if self.merge == "min" else np.maximum
                merged = vecs[0].copy()
                for v in vecs[1:]:
                    merged = op(merged, v)
                new_ages[int(cl)] = merged
            else:
                new_ages[int(cl)] = np.zeros(self.d, np.int32)
        self.cluster_of = labels
        self.ages = new_ages

    @staticmethod
    def _canonicalize(labels: np.ndarray) -> np.ndarray:
        """Noise (-1) becomes unique singletons; relabel to dense ids."""
        labels = labels.copy()
        nxt = labels.max(initial=-1) + 1
        for i, l in enumerate(labels):
            if l < 0:
                labels[i] = nxt
                nxt += 1
        _, dense = np.unique(labels, return_inverse=True)
        return dense.astype(np.int64)

    def clusters(self) -> dict:
        out: dict = {}
        for i, cl in enumerate(self.cluster_of):
            out.setdefault(int(cl), []).append(i)
        return out
