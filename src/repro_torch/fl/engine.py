"""FederatedEngine, the synchronous round (paper Algorithm 1): the port of
``repro.fl.engine`` for the paths of the paper's two settings: the MNIST
MLP (fig3) and the CIFAR CNN (fig5, its BatchNorm statistics held per
client), full participation, the dense age layout, every selection
method of ``make_strategy``, the threshold (or sort) candidate report,
masked compute and the step driver.

One rAge-k round, all on the engine's device:

1. draw each client's H batches from the device shard store;
2. run H Adam steps per client (TF32 off: float32 matmuls and
   convolutions), keep the flat last-step gradient and its top-r
   candidate report (on the card the ``maghist_batch`` and
   ``threshold_topk_batch`` kernels);
3. pick k indices per client by cluster age, disjoint within a cluster
   (``selection='segmented'``: the ``segmented_age_topk`` kernel;
   ``'scan'``: the sequential reference :func:`rage_select`);
4. apply the eq.-(2) age update and count requests (eq. 3);
5. sum the sparse uploads (the ``sparse_aggregate`` kernel) and take a
   global Adam step.

The other methods replace steps 2-4 by their strategy's ``select_batch``
on the (N, d) gradients: rTop-k and CAFe take their candidate report
there (the ``maghist`` kernel, one launch for all clients), top-k and
random-k need none, and dense uploads everything (no kernel at all).

Every M rounds the host pulls the (N, d) request counts, runs DBSCAN and
merges or resets the cluster ages (rAge-k only). The engine updates its
state in place, round by round; the reference threads it through a pure
jitted function instead.

Options of the reference that this path does not take raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import RAgeKConfig
from repro_torch.core.age import AgeState
from repro_torch.core.clustering import cluster_clients, connectivity_matrix
from repro_torch.core.compression import bytes_per_index, bytes_per_round
from repro_torch.core.strategies import (age_select, make_strategy,
                                         segmented_rage_select)
from repro_torch.data.pipeline import DeviceShardStore
from repro_torch.device import resolve, strict_fp32
from repro_torch.fl import client as C
from repro_torch.fl.schedule import SchedState, make_scheduler
from repro_torch.fl.server import aggregate_sparse, aggregate_sparse_fused
from repro_torch.models import paper_nets as P
from repro_torch.optim.optimizers import adam, apply_updates

_WIRE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}


def _todo(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP "
                               f"queue 1, {item})")


class DeviceAgeState(NamedTuple):
    """PS age state on the device, dense layout: ``cluster_age`` (N, d)
    int32 rows keyed by cluster id, ``freq`` (N, d) int32 request counts
    (eq. 3 inputs), ``cluster_of`` (N,) int32 labels."""

    cluster_age: torch.Tensor
    freq: torch.Tensor
    cluster_of: torch.Tensor

    @classmethod
    def create(cls, d: int, n_clients: int, device) -> "DeviceAgeState":
        """t = 0: every client its own singleton cluster row."""
        return cls(
            cluster_age=torch.zeros((n_clients, d), dtype=torch.int32,
                                    device=device),
            freq=torch.zeros((n_clients, d), dtype=torch.int32,
                             device=device),
            cluster_of=torch.arange(n_clients, dtype=torch.int32,
                                    device=device))


@dataclass
class FLResult:
    rounds: list = field(default_factory=list)       # global round index
    loss: list = field(default_factory=list)
    acc: list = field(default_factory=list)
    uplink_bytes: list = field(default_factory=list) # cumulative
    cluster_labels: list = field(default_factory=list)
    heatmaps: dict = field(default_factory=dict)     # round -> (N, N)
    requested: list = field(default_factory=list)    # per round: (N, k)
    n_active: list = field(default_factory=list)     # per round
    aoi_mean: list = field(default_factory=list)
    aoi_peak: list = field(default_factory=list)
    age_mean: list = field(default_factory=list)     # over live cluster rows
    age_peak: list = field(default_factory=list)
    wall_s: float = 0.0

    def summary(self) -> dict:
        return {
            "final_acc": self.acc[-1] if self.acc else float("nan"),
            "final_loss": self.loss[-1] if self.loss else float("nan"),
            "total_uplink_mb": (self.uplink_bytes[-1] / 2**20
                                if self.uplink_bytes else 0.0),
            "peak_aoi": max(self.aoi_peak) if self.aoi_peak else 0.0,
            "mean_aoi": (float(np.mean(self.aoi_mean))
                         if self.aoi_mean else 0.0),
            "peak_coord_age": max(self.age_peak) if self.age_peak else 0.0,
            "wall_s": self.wall_s,
        }


def _build_model(kind: str, generator: torch.Generator, device):
    """(params tree, model state tree ({} for the MLP), apply_loss(tree,
    state, x, y) -> (per-client losses, new state), predict(tree, state,
    x) -> logits)."""
    if kind == "mlp":
        def apply_loss(tree, state, x, y):
            return C.softmax_xent(P.mlp_apply(tree, x), y), state

        def predict(tree, state, x):
            return P.mlp_apply(tree, x)
        return P.mlp_init(generator, device), {}, apply_loss, predict
    if kind == "cnn":
        params, state = P.cnn_init(generator, device)

        def apply_loss(tree, state, x, y):
            logits, new_state = P.cnn_apply(tree, state, x, train=True)
            return C.softmax_xent(logits, y), new_state

        def predict(tree, state, x):
            return P.cnn_apply(tree, state, x, train=False)[0]
        return params, state, apply_loss, predict
    raise ValueError(kind)


def member_age_row(row: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Eq. (2) for one member: the cluster row advances by one and the
    requested coordinates reset (indices outside [0, d) drop)."""
    d = row.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    out = torch.cat([row + 1, row.new_zeros(1)])
    out[torch.where((idx >= 0) & (idx < d), idx, d)] = 0
    return out[:d]


def select_member_topk(cluster_age: torch.Tensor, taken: torch.Tensor | None,
                       cand: torch.Tensor, cl: torch.Tensor, *,
                       k: int) -> torch.Tensor:
    """One member's age-top-k pick: ``cand`` (r,) int64 candidates, ``cl``
    (1,) its cluster id; candidates in the cluster's ``taken`` row (None:
    not disjoint) read age -1. Age ties go to the larger magnitude."""
    ages = cluster_age.index_select(0, cl)[0].gather(0, cand)
    if taken is not None:
        ages = torch.where(taken.index_select(0, cl)[0].gather(0, cand), -1,
                           ages)
    return age_select(cand, ages, k)[1]


def rage_select(age: DeviceAgeState, *, k: int, cands: torch.Tensor,
                disjoint: bool = True):
    """Algorithm 1 steps 2-3 + eq. (2), sequentially over clients: the
    reference the segmented plane is pinned to (``selection='scan'``).

    Clients go in order; within a cluster, indices already requested this
    round are excluded for the later members (disjointness, §II). Every
    client reads round-start ages; eq. (2) then applies member by member
    (+1 per member, requested set to 0). ``cands`` is the (N, r) report.
    Every client takes part. Returns (idx (N, k) int32, new
    DeviceAgeState)."""
    n = cands.shape[0]
    cands = cands.to(torch.int64)
    cl = age.cluster_of.to(torch.int64)
    taken = (torch.zeros(age.cluster_age.shape, dtype=torch.bool,
                         device=cands.device) if disjoint else None)
    rows = []
    for i in range(n):
        idx_i = select_member_topk(age.cluster_age, taken, cands[i],
                                   cl[i:i + 1], k=k)
        if disjoint:
            taken[cl[i:i + 1], idx_i] = True
        rows.append(idx_i)
    idx = torch.stack(rows)
    cluster_age = age.cluster_age.clone()
    for i in range(n):
        row = cluster_age.index_select(0, cl[i:i + 1])[0]
        cluster_age.index_copy_(0, cl[i:i + 1],
                                member_age_row(row, idx[i]).unsqueeze(0))
    freq = age.freq.scatter_add(1, idx, torch.ones_like(age.freq[:, :k]))
    return idx.to(torch.int32), age._replace(cluster_age=cluster_age,
                                             freq=freq)


def apply_global(g_opt, g_sum, g_params, g_opt_state):
    """The PS's global update from an aggregated flat gradient."""
    updates, g_opt_state = g_opt.update(g_sum, g_opt_state, g_params)
    return apply_updates(g_params, updates), g_opt_state


def build_eval_sets(shards, test, *, device, cap: int = 1024):
    """Per-client eval subsets: the test samples of the labels each client
    holds, at most ``cap`` of them."""
    xte, yte = test
    out = []
    for (_, ys) in shards:
        sel = np.isin(yte, np.unique(ys))
        out.append((torch.from_numpy(np.asarray(xte[sel][:cap],
                                                np.float32)).to(device),
                    torch.from_numpy(np.asarray(yte[sel][:cap],
                                                np.int64)).to(device)))
    return out


def rage_select_segmented(age: DeviceAgeState, *, r: int, k: int,
                          cands: torch.Tensor, d: int,
                          num_segments: int | None = None,
                          max_seg: int | None = None,
                          disjoint: bool = True):
    """Segmented selection on a precomputed candidate report plus the
    request count update. Returns (idx (N, k) int32, new DeviceAgeState,
    SegmentedSelection)."""
    idx, new_ca, seg = segmented_rage_select(
        None, age.cluster_age, age.cluster_of, r=r, k=k,
        num_segments=num_segments, max_seg=max_seg, disjoint=disjoint,
        cands=cands, d=d)
    # every client takes part, so every idx entry is a real coordinate
    freq = age.freq.scatter_add(1, idx.to(torch.int64),
                                torch.ones_like(idx))
    return idx, age._replace(cluster_age=new_ca, freq=freq), seg


def _recluster_host(freq: np.ndarray, cluster_age: np.ndarray,
                    cluster_of: np.ndarray, eps: float, min_pts: int):
    """Eq. (3) similarity -> DBSCAN -> merge/reset of the cluster age rows
    (``AgeState.apply_clusters``). Returns (new (N, d) int32 cluster_age,
    (N,) labels)."""
    n, d = freq.shape
    labels = cluster_clients(freq, eps, min_pts)
    st = AgeState.from_cluster_rows(cluster_age, cluster_of)
    st.apply_clusters(labels)
    new_ca = np.zeros((n, d), np.int32)
    for c, v in st.ages.items():
        new_ca[c] = v
    return new_ca, st.cluster_of


class FederatedEngine:
    """Owns the paper's round loop on one device.

    Usage::

        engine = FederatedEngine("mlp", shards, test, hp, seed=0)
        result = engine.run(rounds=200, eval_every=5)

    ``kind`` is ``"mlp"`` (Network-1) or ``"cnn"`` (Network-2).
    ``device=None`` means the CUDA card and raises without one;
    ``device="cpu"`` runs the kernels' plain versions. ``params`` (a
    parameter tree, e.g. from ``weights.params_from_jax``) replaces the
    seeded initial weights, ``state`` (the CNN's BatchNorm statistics,
    ``{"conv{i}": {"mean", "var"}}``) the initial model state; every
    client starts from both.
    """

    def __init__(self, kind: str, shards: list, test: tuple,
                 hp: RAgeKConfig, *, seed: int = 0, device=None,
                 params=None, state=None, ef: bool = False,
                 selection: str = "segmented", compute: str = "auto",
                 faults=None):
        if selection not in ("scan", "segmented"):
            raise ValueError(f"selection must be 'scan' or 'segmented', "
                             f"got {selection!r}")
        if compute == "gathered":
            raise _todo("compute='gathered'", "item 10: participation "
                        "and compute planes")
        if compute not in ("auto", "masked"):
            raise ValueError(f"compute must be 'auto', 'gathered' or "
                             f"'masked', got {compute!r}")
        if hp.age_layout != "dense":
            raise _todo(f"age_layout={hp.age_layout!r}", "item 11: the "
                        "hierarchical age layout")
        if ef:
            raise _todo("ef=True", "items 3 and 5: error feedback")
        if faults is not None:
            raise _todo("faults", "item 13: resilience")
        self.device = dev = resolve(device)
        self.hp = hp
        self.kind = kind
        self.n = n = len(shards)
        self.seed = seed
        init, state0, apply_loss, self._predict = _build_model(
            kind, torch.Generator().manual_seed(seed), dev)
        if params is None:
            params = init
        if state is None:
            state = state0
        self._unflatten = C.unflattener(params)
        self.g_params = C.flatten_tree(params).to(device=dev,
                                                  dtype=torch.float32)
        self.d = d = self.g_params.shape[0]
        # rage_k's 'segmented' (per-cluster parallel) or 'scan' (the
        # sequential reference, equal to it)
        self._selection = selection
        self._strategy = make_strategy(hp.method, r=hp.r, k=hp.k,
                                       lam=hp.cafe_lam,
                                       candidates=hp.candidates)
        # rage_k takes its top-r report in the local phase; the other
        # r-candidate methods take theirs in their strategy
        self._local_phase = C.make_local_phase(
            apply_loss, self._unflatten, hp.lr,
            report_r=hp.r if hp.method == "rage_k" else None,
            report_impl=hp.candidates)
        # the draws of rtop_k and random_k
        self._gen = torch.Generator(device=dev).manual_seed(seed + 99)
        self._g_opt = adam(hp.lr)
        self._scheduler = make_scheduler(hp.schedule, n, device=dev)
        self._wire_dtype = _WIRE[hp.wire_dtype]
        # segmented packing bounds (live cluster count, largest cluster),
        # recomputed from the host DBSCAN labels at every recluster
        self._num_seg = n
        self._max_seg = 1

        self.g_opt_state = self._g_opt.init(self.g_params)
        self.params_s = C.broadcast_global(self.g_params, n)
        self.opt_s = adam(hp.lr).init(self.params_s, batch_dims=1)
        # per-client model state (the CNN's BatchNorm running statistics):
        # leaves (N, ...)
        self.state_s = (C.tree_map(lambda t: t.to(dev, torch.float32),
                                   C.stack_clients([state] * n))
                        if state else {})
        self.age = DeviceAgeState.create(d, n, dev)
        self.sched = SchedState.create(n, dev)
        self.round_idx = 0

        self._store = DeviceShardStore(shards, hp.batch_size,
                                       seed=seed + 17, device=dev)
        self._data = self._store.data
        self.samp = self._store.init_state()
        self._eval_sets = build_eval_sets(shards, test, device=dev)

        # uplink per client per round: the whole gradient (dense), or k
        # values + indices, plus the top-r candidate report uploaded for
        # PS selection (rage_k, cafe)
        if hp.method == "dense":
            self._per_client_bytes = bytes_per_round(
                0, d, dense=True, wire_dtype=hp.wire_dtype)
        else:
            self._per_client_bytes = bytes_per_round(
                hp.k, d, wire_dtype=hp.wire_dtype)
            if hp.method in ("rage_k", "cafe"):
                self._per_client_bytes += hp.r * bytes_per_index(d)
        self.cum_bytes = 0
        self.device_s = 0.0
        self.recluster_s = 0.0

    @property
    def params(self) -> dict:
        """The global parameters as a tree of views."""
        return self._unflatten(self.g_params)

    def _select(self, G: torch.Tensor, cands, plan):
        """Step 3 for the engine's method: (idx (N, k) int32, or None for
        dense; the SegmentedSelection of rage_k's segmented plane, or
        None). Updates the age state in place."""
        hp, d = self.hp, self.d
        seg = None
        if hp.method == "rage_k":
            if self._selection == "segmented":
                idx, self.age, seg = rage_select_segmented(
                    self.age, r=hp.r, k=hp.k, cands=cands, d=d,
                    num_segments=self._num_seg,
                    max_seg=min(self._max_seg, plan.m),
                    disjoint=hp.disjoint_in_cluster)
            else:
                idx, self.age = rage_select(self.age, k=hp.k, cands=cands,
                                            disjoint=hp.disjoint_in_cluster)
        elif hp.method == "cafe":
            # per-client cost-and-age selection: cluster_age doubles as the
            # per-client age rows (clusters stay singletons: no recluster
            # on this method) and freq holds the cumulative cost
            idx, _, (ca, cost) = self._strategy.select_batch(
                G, (self.age.cluster_age, self.age.freq))
            self.age = self.age._replace(cluster_age=ca, freq=cost)
        elif hp.method == "dense":
            return None, None
        elif hp.method in ("rtop_k", "random_k"):
            idx, _, _ = self._strategy.select_batch(G, self._gen)
        else:                                       # top_k, deterministic
            idx, _, _ = self._strategy.select_batch(G, ())
        # clients outside the round request nothing: sentinel-d rows, set
        # in this one place so that no method can forget them
        return torch.where(plan.active.unsqueeze(1), idx, d), seg

    def _round_impl(self, bx: torch.Tensor, by: torch.Tensor) -> dict:
        """One global round from the clients' batches (bx (N, H, B, ...),
        by (N, H, B)). Updates the engine state in place and returns the
        round's device tensors: losses (N,), the last-step gradients G
        (N, d), idx (N, k) (None for dense), the aggregated gradient g_sum
        (d,), and the participation and age scalars."""
        hp, n, d = self.hp, self.n, self.d
        plan = self._scheduler.plan(self.sched)
        with record_function("local_phase"), strict_fp32():
            _, self.opt_s, self.state_s, G, cands, losses = \
                self._local_phase(self.params_s, self.opt_s, self.state_s,
                                  bx, by)

        with record_function("select"):
            idx, seg = self._select(G, cands, plan)
        with record_function("aggregate"):
            if idx is None:
                # dense: every taking part client uploads G in wire form
                gw = G.to(self._wire_dtype).to(G.dtype)
                g_sum = torch.where(plan.active.unsqueeze(1), gw, 0.0).sum(0)
            else:
                vals = G.gather(1, idx.to(torch.int64).clamp(max=d - 1))
                vals = vals.to(self._wire_dtype).to(G.dtype)
            if seg is not None:
                # the segmented layout feeds aggregation directly: padded
                # member slots carry the sentinel index d, which the
                # kernel drops
                ok = (seg.members < n).unsqueeze(-1)
                seg_vals = torch.where(
                    ok, vals[seg.members.clamp(max=n - 1).to(torch.int64)],
                    0.0)
                g_sum, _ = aggregate_sparse_fused(
                    seg.idx, seg_vals, torch.zeros(d, dtype=torch.int32,
                                                   device=self.device))
            elif idx is not None:
                g_sum = aggregate_sparse(idx, vals, d)
        with record_function("global_update"):
            self.g_params, self.g_opt_state = apply_global(
                self._g_opt, g_sum, self.g_params, self.g_opt_state)
            self.params_s = C.broadcast_global(self.g_params, n)

        aoi = torch.where(plan.active, 0, self.sched.aoi + 1)
        self.sched = SchedState(rnd=self.sched.rnd + 1, aoi=aoi)
        live = torch.zeros(self.age.cluster_age.shape[0], dtype=torch.bool,
                           device=self.device)
        live[self.age.cluster_of.to(torch.int64)] = True
        ca_live = torch.where(live.unsqueeze(1), self.age.cluster_age, 0)
        return {
            "losses": losses,
            "G": G,
            "idx": idx,
            "g_sum": g_sum,
            "n_active": plan.active.sum(),
            "aoi_mean": aoi.to(torch.float32).mean(),
            "aoi_peak": aoi.max(),
            "age_mean": (ca_live.to(torch.float32).sum()
                         / (live.sum().to(torch.float32) * d)),
            "age_peak": ca_live.max(),
        }

    def step(self) -> dict:
        """Advance one global round. Returns host values: losses (N,),
        idx (N, k) (None for dense), n_active, aoi_mean, aoi_peak,
        age_mean, age_peak."""
        t0 = time.perf_counter()
        with record_function("draw"):
            bx, by, self.samp = self._store.draw(self._data, self.samp,
                                                 self.hp.H)
        m = self._round_impl(bx, by)
        with record_function("metrics"):
            out = {"losses": m["losses"].cpu().numpy(),
                   "idx": (m["idx"].cpu().numpy()
                           if m["idx"] is not None else None),
                   "n_active": int(m["n_active"]),
                   "aoi_mean": float(m["aoi_mean"]),
                   "aoi_peak": int(m["aoi_peak"]),
                   "age_mean": float(m["age_mean"]),
                   "age_peak": int(m["age_peak"])}
        self.device_s += time.perf_counter() - t0
        self.round_idx += 1
        self.cum_bytes += self._per_client_bytes * out["n_active"]
        if self.hp.method == "rage_k" and self.round_idx % self.hp.M == 0:
            with record_function("recluster"):
                self._recluster()
        return out

    def _recluster(self):
        """The every-M host round trip: request counts and cluster rows
        come down, DBSCAN + merge/reset run on the host, rows and labels
        go back up."""
        t0 = time.perf_counter()
        new_ca, labels = _recluster_host(
            self.age.freq.cpu().numpy(), self.age.cluster_age.cpu().numpy(),
            self.age.cluster_of.cpu().numpy(), self.hp.eps, self.hp.min_pts)
        self.age = self.age._replace(
            cluster_age=torch.from_numpy(new_ca).to(self.device),
            cluster_of=torch.from_numpy(labels.astype(np.int32)).to(
                self.device))
        self._num_seg = int(labels.max()) + 1
        self._max_seg = int(np.bincount(labels).max())
        self.recluster_s += time.perf_counter() - t0

    @property
    def cluster_of(self) -> np.ndarray:
        return self.age.cluster_of.cpu().numpy().astype(np.int64)

    @property
    def freq_matrix(self) -> np.ndarray:
        """The cumulative (N, d) request-frequency matrix (eq.-3 inputs).
        CAFe's cost rows stand in for it, as the reference stores them
        there; methods that never request return zeros."""
        return self.age.freq.cpu().numpy()

    @torch.no_grad()
    def eval_acc(self) -> float:
        """Mean over clients of each client's accuracy on its own labels,
        each with its own parameters and model state."""
        t0 = time.perf_counter()
        accs = []
        for i, (xe, ye) in enumerate(self._eval_sets):
            with strict_fp32():
                logits = self._predict(self._unflatten(self.params_s[i]),
                                       C.client_tree(self.state_s, i), xe)
            accs.append((logits.argmax(-1) == ye).to(torch.float32).mean())
        acc = float(torch.stack(accs).mean())
        self.device_s += time.perf_counter() - t0
        return acc

    def run(self, rounds: int, *, eval_every: int = 5, heatmap_at=(),
            verbose: bool = False) -> FLResult:
        t0 = time.time()
        res = FLResult()
        end = self.round_idx + rounds
        while self.round_idx < end:
            m = self.step()
            res.requested.append(m["idx"])
            for key in ("n_active", "aoi_mean", "aoi_peak", "age_mean",
                        "age_peak"):
                getattr(res, key).append(m[key])
            t = self.round_idx
            if t % eval_every == 0 or t == end:
                acc = self.eval_acc()
                loss = float(np.nanmean(m["losses"]))
                res.rounds.append(t)
                res.loss.append(loss)
                res.acc.append(acc)
                res.uplink_bytes.append(self.cum_bytes)
                res.cluster_labels.append(self.cluster_of)
                if verbose:
                    print(f"[{self.hp.method}] round {t:4d} "
                          f"loss={loss:.4f} acc={acc:.4f} "
                          f"upl={self.cum_bytes / 2**20:.2f}MB")
            if t in heatmap_at:
                res.heatmaps[t] = connectivity_matrix(self.freq_matrix)
        res.wall_s = time.time() - t0
        return res
