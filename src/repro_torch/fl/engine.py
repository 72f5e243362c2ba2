"""FederatedEngine, the synchronous round (paper Algorithm 1): the port of
``repro.fl.engine`` for the paths of the paper's two settings: the MNIST
MLP (fig3) and the CIFAR CNN (fig5, its BatchNorm statistics held per
client), both age layouts (dense, and hierarchical: cluster-keyed age
rows compacted at every recluster and a request-log ring in place of the
(N, d) counts), every selection method of
``make_strategy``, the threshold (or sort) candidate report, error
feedback, the participation plane (``fl.schedule``: full, uniform m of
N, AoI-balanced, deadline), the compute plane (masked or gathered), and
both drivers: ``run`` (a round a step) and ``run_scanned`` (chunks of
rounds, each round on the card one replay of a CUDA graph of the round
body), checkpoint/resume of the whole round state (``save_state``,
``load_state``, ``checkpointer=`` of either driver), and fault injection
(``faults=``, a ``fl.faults.FaultModel``, with the PS's validation
gate).

One rAge-k round, all on the engine's device:

1. ask the scheduler for the round's plan (who takes part, who is late);
2. draw each client's H batches from the device shard store (gathered:
   the active clients' only);
3. run H Adam steps per client (TF32 off: float32 matmuls and
   convolutions), keep the flat last-step gradient plus the
   error-feedback residual, and its top-r candidate report (on the card
   the ``maghist_batch`` and ``threshold_topk_batch`` kernels);
4. pick k indices per active client by cluster age, disjoint within a
   cluster (``selection='segmented'``: the ``segmented_age_topk``
   kernel; ``'scan'``: the sequential reference :func:`rage_select`);
5. apply the eq.-(2) age update (clients outside the round age with no
   reset) and count requests (eq. 3);
6. sum the sparse uploads, late ones staleness-weighted (the
   ``sparse_aggregate`` kernel), take a global Adam (or SGD) step, and
   keep what each client did not send as its error-feedback residual.

The other methods replace steps 3-5 by their strategy's ``select_batch``
on the gradients: rTop-k and CAFe take their candidate report there (on
the card the same two report kernels), top-k and random-k need none,
and dense uploads everything (no kernel at all).

``compute='masked'`` trains all N clients and discards the rows outside
the round; ``'gathered'`` compacts the active ids to the scheduler's
bound m (padded with the sentinel N), trains those m rows only and
scatters the results back, so a gathered round equals the masked one
(``'auto'`` gathers exactly when m < N). Under full participation every
mask is skipped: the round is the full-participation program.

Under ``faults=`` a crashed client sits the round out before the compute
plane (its state and data stream held); after the local phase the wire
faults corrupt or drop updates, and the validation gate (``quarantine``:
finite rows with ``|g| <= gate_bound``) keeps the rest out. ``act_ps``,
the clients the PS hears from, then drives selection, the ages, the
request rows, the aggregate, the ef residual and the AoI, while the
clients that trained (``act``) drive the local plane, the log's members,
the upload cost and ``n_active``.

Every M rounds the host pulls the (N, d) request counts (hierarchical:
drains the log ring into its own copy of them), runs DBSCAN and merges
or resets the cluster ages (rAge-k only): inline under ``run``, on a
worker thread under ``run_scanned``. The engine's state is a fixed
set of buffers that each round updates in place (a graph replays on the
addresses it captured); the reference threads it through a pure jitted
function instead.

"""
from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.checkpoint.io import load_checkpoint
from repro_torch.configs.base import RAgeKConfig
from repro_torch.core.age import AgeState
from repro_torch.core.clustering import (cluster_clients,
                                         connectivity_matrix,
                                         fold_request_log)
from repro_torch.core.compression import bytes_per_index, bytes_per_round
from repro_torch.core.strategies import (age_select, make_strategy,
                                         segmented_rage_select)
from repro_torch.data.pipeline import DeviceShardStore
from repro_torch.device import resolve, strict_fp32
from repro_torch.fl import client as C
from repro_torch.fl.graphs import GraphCache
from repro_torch.fl.schedule import RoundPlan, SchedState, make_scheduler
from repro_torch.fl.server import aggregate_sparse, aggregate_sparse_fused
from repro_torch.models import paper_nets as P
from repro_torch.optim.optimizers import adam, apply_updates, sgd

_WIRE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}
# the reference's names for the aggregation hand-off (see FederatedEngine)
AGGREGATE_IMPLS = ("auto", "jnp", "pallas")


class DeviceAgeState(NamedTuple):
    """PS age state on the device. Two layouts share this container
    (``age_layout='dense'|'hierarchical'``); in both, ``cluster_age``
    rows are keyed by cluster id (eq. (2) makes ages cluster-shared):

    field        dense                hierarchical
    -----------  -------------------  ---------------------------------
    cluster_age  (N, d) int32; rows   (C, d) int32: C live clusters,
                 past the live count  reallocated at every recluster
                 stay zero            (N at t = 0)
    freq         (N, d) int32 eq.-3   None: the host folds the request
                 request counts       log into its own (N, d) matrix
    cluster_of   (N,) int32 labels    (N,) int32 labels
    cost         None                 CAFe only: (N, d) int32 upload
                                      cost rows (dense keeps them in
                                      ``freq``)
    upload_cost  None                 (N,) int32 entries uploaded so far
    log_idx      None                 (L, m_bound, k) int32 ring of the
                                      requested indices (sentinel d)
    log_mem      None                 (L, m_bound) int32 requesting ids
                                      (sentinel N: a padded slot)
    log_ptr      None                 () int32 monotone write pointer;
                                      slot ``log_ptr % L``

    The ring (rAge-k only, L = M: one recluster window) replaces the
    dense ``freq`` as the DBSCAN input: the boundary pulls M·m·(k+1)·4
    bytes instead of N·d·4."""

    cluster_age: torch.Tensor
    freq: torch.Tensor | None
    cluster_of: torch.Tensor
    cost: torch.Tensor | None = None
    upload_cost: torch.Tensor | None = None
    log_idx: torch.Tensor | None = None
    log_mem: torch.Tensor | None = None
    log_ptr: torch.Tensor | None = None

    @classmethod
    def create(cls, d: int, n_clients: int, device) -> "DeviceAgeState":
        """Dense layout at t = 0: every client its own singleton cluster
        row, and the (N, d) request counts."""
        return cls(
            cluster_age=torch.zeros((n_clients, d), dtype=torch.int32,
                                    device=device),
            freq=torch.zeros((n_clients, d), dtype=torch.int32,
                             device=device),
            cluster_of=torch.arange(n_clients, dtype=torch.int32,
                                    device=device))

    @classmethod
    def create_hierarchical(cls, d: int, n_clients: int, *,
                            log_len: int = 0, m_bound: int = 0, k: int = 0,
                            with_cost: bool = False,
                            device=None) -> "DeviceAgeState":
        """Hierarchical layout at t = 0: N singleton rows, which shrink
        to the live count at the first merging recluster. ``log_len``,
        ``m_bound`` and ``k`` size the request-log ring (``log_len`` 0:
        no ring, for methods that never recluster); ``with_cost`` adds
        CAFe's cost rows. ``device=None`` means the card."""
        dev = resolve(device)
        log = log_len > 0

        def full(shape, value):
            return torch.full(shape, value, dtype=torch.int32, device=dev)
        return cls(
            cluster_age=full((n_clients, d), 0),
            freq=None,
            cluster_of=torch.arange(n_clients, dtype=torch.int32,
                                    device=dev),
            cost=full((n_clients, d), 0) if with_cost else None,
            upload_cost=full((n_clients,), 0),
            log_idx=full((log_len, m_bound, k), d) if log else None,
            log_mem=full((log_len, m_bound), n_clients) if log else None,
            log_ptr=full((), 0) if log else None)

    @property
    def device_bytes(self) -> int:
        """Bytes of every tensor of the age plane."""
        return sum(t.numel() * t.element_size() for t in self
                   if t is not None)


def drain_request_log(age: DeviceAgeState, freq_host: np.ndarray,
                      seen: int, *, n: int, d: int) -> int:
    """Pull the request-log slots written since the watermark ``seen``
    and fold them into the host's (N, d) frequency matrix: the
    hierarchical layout's boundary pull, (ptr - seen)·m·(k+1)·4 bytes.
    Returns the new watermark (``log_ptr``). The caller holds no other
    reader of ``freq_host`` meanwhile."""
    ptr = int(age.log_ptr)
    if ptr == seen:
        return seen
    L = int(age.log_idx.shape[0])
    # the ring covers one recluster window and every recluster drains,
    # so the device's writes never lap the watermark
    assert ptr - seen <= L, (
        f"request log overran: ptr={ptr} seen={seen} L={L}")
    slots = torch.tensor([p % L for p in range(seen, ptr)],
                         device=age.log_idx.device)
    fold_request_log(freq_host, age.log_mem.index_select(0, slots).cpu()
                     .numpy(), age.log_idx.index_select(0, slots).cpu()
                     .numpy(), n_clients=n, d=d)
    return ptr


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
    # updates quarantined by the validation gate, clients crashed by the
    # fault model, wire-dropped updates (all 0 without faults)
    n_quarantined: list = field(default_factory=list)
    n_crashed: list = field(default_factory=list)
    n_dropped: list = field(default_factory=list)
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
            "total_quarantined": int(sum(self.n_quarantined)),
            "total_crashed": int(sum(self.n_crashed)),
            "total_dropped": int(sum(self.n_dropped)),
            "wall_s": self.wall_s,
        }


_RESULT_LISTS = ("rounds", "loss", "acc", "uplink_bytes", "n_active",
                 "aoi_mean", "aoi_peak", "age_mean", "age_peak",
                 "n_quarantined", "n_crashed", "n_dropped")


def _result_to_json(res: FLResult) -> dict:
    """An FLResult as JSON for a checkpoint's meta (Python floats
    round-trip JSON exactly, so a resumed run's curves are bitwise the
    uninterrupted run's)."""
    out = {key: list(getattr(res, key)) for key in _RESULT_LISTS}
    out["cluster_labels"] = [np.asarray(c).tolist()
                             for c in res.cluster_labels]
    out["heatmaps"] = {str(t): np.asarray(h).tolist()
                       for t, h in res.heatmaps.items()}
    out["requested"] = [None if r is None else np.asarray(r).tolist()
                        for r in res.requested]
    return out


def _result_from_json(d: dict | None) -> FLResult:
    res = FLResult()
    if not d:
        return res
    for key in _RESULT_LISTS:
        # a meta written before the fault counters reads them as empty
        setattr(res, key, list(d.get(key, [])))
    res.cluster_labels = [np.asarray(c, np.int64)
                          for c in d["cluster_labels"]]
    res.heatmaps = {int(t): np.asarray(h) for t, h in d["heatmaps"].items()}
    res.requested = [None if r is None else np.asarray(r, np.int32)
                     for r in d["requested"]]
    return res


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
    out.index_fill_(0, torch.where((idx >= 0) & (idx < d), idx, d), 0)
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


def count_requests(freq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Eq.-(3) request counts: +1 at each of client i's requested indices
    in row i of ``freq`` (N, d); sentinel-d entries (clients outside the
    round) land in a spare column that is cut off."""
    n, d = freq.shape
    spare = torch.cat([freq, freq.new_zeros((n, 1))], dim=1)
    idx = idx.to(torch.int64)
    return spare.scatter_add_(1, idx, torch.ones_like(
        idx, dtype=freq.dtype))[:, :d]


def _counted(freq: torch.Tensor | None, idx: torch.Tensor):
    """The request counts after ``idx``; None under the hierarchical
    layout, whose requests go to the log ring instead."""
    return None if freq is None else count_requests(freq, idx)


def rage_select(age: DeviceAgeState, *, k: int, cands: torch.Tensor,
                disjoint: bool = True, active: torch.Tensor | None = None):
    """Algorithm 1 steps 2-3 + eq. (2), sequentially over clients: the
    reference the segmented plane is pinned to (``selection='scan'``).

    Clients go in order; within a cluster, indices already requested this
    round are excluded for the later members (disjointness, §II). Every
    client reads round-start ages; eq. (2) then applies member by member
    (+1 per member, requested set to 0). ``cands`` is the (N, r) report.
    ``active`` ((N,) bool; None: every client) is the participation
    plane's mask: inactive clients request nothing (sentinel-d rows) and
    enter no ``taken`` set, and their +1s apply first, with no reset.
    Returns (idx (N, k) int32, new DeviceAgeState)."""
    n = cands.shape[0]
    d = age.cluster_age.shape[1]
    cands = cands.to(torch.int64)
    cl = age.cluster_of.to(torch.int64)
    # a spare column takes the sentinel picks of inactive clients
    taken = (torch.zeros((age.cluster_age.shape[0], d + 1),
                         dtype=torch.bool, device=cands.device)
             if disjoint else None)
    # a device scalar: a Python one would be copied up at every write
    true = torch.ones((), dtype=torch.bool, device=cands.device)
    rows = []
    for i in range(n):
        idx_i = select_member_topk(age.cluster_age, taken, cands[i],
                                   cl[i:i + 1], k=k)
        if active is not None:
            idx_i = torch.where(active[i], idx_i, d)
        if disjoint:
            taken.index_put_((cl[i:i + 1], idx_i), true)
        rows.append(idx_i)
    idx = torch.stack(rows)
    cluster_age = age.cluster_age.clone()
    if active is not None:
        # inactive members' +1s commute (they reset nothing): first
        cluster_age += torch.zeros(
            cluster_age.shape[0], dtype=cluster_age.dtype,
            device=cl.device).index_add_(
            0, cl, (~active).to(cluster_age.dtype)).unsqueeze(1)
    for i in range(n):
        row = cluster_age.index_select(0, cl[i:i + 1])[0]
        new_row = member_age_row(row, idx[i])
        if active is not None:
            new_row = torch.where(active[i], new_row, row)
        cluster_age.index_copy_(0, cl[i:i + 1], new_row.unsqueeze(0))
    return idx.to(torch.int32), age._replace(
        cluster_age=cluster_age, freq=_counted(age.freq, idx))


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
                          disjoint: bool = True,
                          active: torch.Tensor | None = None):
    """Segmented selection on a precomputed candidate report plus the
    request count update; ``active`` as in :func:`rage_select`. Returns
    (idx (N, k) int32, new DeviceAgeState, SegmentedSelection)."""
    idx, new_ca, seg = segmented_rage_select(
        None, age.cluster_age, age.cluster_of, r=r, k=k,
        num_segments=num_segments, max_seg=max_seg, disjoint=disjoint,
        cands=cands, d=d, active=active)
    return idx, age._replace(cluster_age=new_ca,
                             freq=_counted(age.freq, idx)), seg


def _recluster_host(freq: np.ndarray, cluster_age: np.ndarray,
                    cluster_of: np.ndarray, eps: float, min_pts: int,
                    compact: bool = False):
    """Eq. (3) similarity -> DBSCAN -> merge/reset of the cluster age rows
    (``AgeState.apply_clusters``; ``cluster_age`` has N rows or, under the
    hierarchical layout, C). Returns (new int32 cluster_age: (N, d), or
    with ``compact`` the (C_new, d) live rows keyed by the canonical
    labels; (N,) labels)."""
    n, d = freq.shape
    labels = cluster_clients(freq, eps, min_pts)
    st = AgeState.from_cluster_rows(cluster_age, cluster_of)
    st.apply_clusters(labels)
    rows = int(st.cluster_of.max()) + 1 if compact else n
    new_ca = np.zeros((rows, d), np.int32)
    for c, v in st.ages.items():
        new_ca[c] = v
    return new_ca, st.cluster_of


def recluster_packed(age: DeviceAgeState, eps: float, min_pts: int):
    """Eq. (3) similarity -> DBSCAN -> merge/reset of the cluster age rows
    on a dense-layout state, as a function: the (N, d) counts and the
    rows come down, the new rows and labels go back to the age's device.
    Returns (new DeviceAgeState, host (N,) labels)."""
    new_ca, labels = _recluster_host(
        age.freq.cpu().numpy(), age.cluster_age.cpu().numpy(),
        age.cluster_of.cpu().numpy(), eps, min_pts)
    dev = age.cluster_age.device
    return age._replace(
        cluster_age=torch.from_numpy(new_ca).to(dev),
        cluster_of=torch.from_numpy(labels.astype(np.int32)).to(dev)), labels


def recluster(age: DeviceAgeState, eps: float,
              min_pts: int) -> DeviceAgeState:
    """:func:`recluster_packed` without the labels."""
    return recluster_packed(age, eps, min_pts)[0]


def _write(dst, src):
    """Copy a tree of new tensors (tensors, tuples, NamedTuples, dicts) into
    the buffers of the same tree, in place: the engine's state keeps its
    addresses, which a captured CUDA graph reads and writes. A buffer
    handed back unchanged is not copied onto itself."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for key in dst:
            _write(dst[key], src[key])
    else:
        for a, b in zip(dst, src):
            if a is not None:
                _write(a, b)


class FederatedEngine:
    """Owns the paper's round loop on one device.

    Usage::

        engine = FederatedEngine("mlp", shards, test, hp, seed=0)
        result = engine.run_scanned(rounds=200, eval_every=5)

    ``kind`` is ``"mlp"`` (Network-1) or ``"cnn"`` (Network-2).
    ``device=None`` means the CUDA card and raises without one;
    ``device="cpu"`` runs the kernels' plain versions. ``params`` (a
    parameter tree, e.g. from ``weights.params_from_jax``) replaces the
    seeded initial weights, ``state`` (the CNN's BatchNorm statistics,
    ``{"conv{i}": {"mean", "var"}}``) the initial model state; every
    client starts from both. ``ef`` keeps an (N, d) error-feedback
    residual per client; ``global_opt`` is the PS's optimizer ('adam' or
    'sgd'); ``compute`` the compute plane ('auto', 'gathered' or
    'masked'); ``hp.schedule`` the participation plane. ``faults`` (a
    ``fl.faults.FaultModel`` over the same N clients) injects crashes and
    wire faults, keyed by ``seed + 77`` and the round; ``quarantine``
    turns the PS's validation gate on (finite rows, ``|g| <=
    gate_bound``). ``aggregate_impl`` keeps the reference's names for how
    rAge-k's segmented selection hands its uploads to the aggregation:
    'pallas' (and 'auto') the segmented (C, S, k) layout straight into
    ``aggregate_sparse_fused``, 'jnp' the per-client (N, k) rows through
    ``aggregate_sparse``; on the card both launch the CUDA
    ``sparse_aggregate``. The kernel sums in upload order, cluster-major
    or client-major: where three or more uploads hit one index the two
    can round apart.

    Two drivers run the same round body on the same state: :meth:`run`
    steps eagerly and pulls every round's metrics; :meth:`run_scanned`
    runs chunks of rounds between the host's stops, on the card each
    round one replay of a CUDA graph of the body, and pulls a chunk's
    metrics once. Their results are bitwise equal, and either may follow
    the other.
    """

    def __init__(self, kind: str, shards: list, test: tuple,
                 hp: RAgeKConfig, *, seed: int = 0, device=None,
                 params=None, state=None, ef: bool = False,
                 global_opt: str = "adam", selection: str = "segmented",
                 compute: str = "auto", faults=None,
                 quarantine: bool = True, gate_bound: float = 1e4,
                 aggregate_impl: str = "auto"):
        if aggregate_impl not in AGGREGATE_IMPLS:
            raise ValueError(f"aggregate_impl must be one of "
                             f"{AGGREGATE_IMPLS}, got {aggregate_impl!r}")
        if selection not in ("scan", "segmented"):
            raise ValueError(f"selection must be 'scan' or 'segmented', "
                             f"got {selection!r}")
        if compute not in ("auto", "gathered", "masked"):
            raise ValueError(f"compute must be 'auto', 'gathered' or "
                             f"'masked', got {compute!r}")
        if global_opt not in ("adam", "sgd"):
            raise ValueError(f"global_opt must be 'adam' or 'sgd', got "
                             f"{global_opt!r}")
        if faults is not None and faults.n != len(shards):
            raise ValueError(f"FaultModel.n={faults.n} != {len(shards)} "
                             f"clients")
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
        # how the segmented selection's uploads reach the aggregation:
        # 'pallas' hands the (C, S, k) layout over as it is, 'jnp' the
        # per-client (N, k) rows; either way ops.sparse_aggregate
        self._agg_impl = ("pallas" if aggregate_impl == "auto"
                          else aggregate_impl)
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
        self._g_opt = adam(hp.lr) if global_opt == "adam" else sgd(hp.lr)
        # participation plane: who takes part, planned on the device from
        # the scheduler state (seed, round counter, client AoI)
        self._scheduler = make_scheduler(
            hp.schedule, n, participation_m=hp.participation_m,
            deadline_s=hp.deadline_s, seed=seed + 41, device=dev)
        # the fault model (None when it can inject nothing: the round is
        # then the unfaulted one) with its key, and the validation gate
        self._faults = faults if faults is not None and faults.any else None
        self._fault_key = seed + 77
        self._quarantine = bool(quarantine)
        self._gate_bound = float(gate_bound)
        # every mask of the round is all-true: skip them all
        self._full = (self._scheduler.name == "full"
                      and self._faults is None)
        # compute plane: 'gathered' trains only the m_bound compacted
        # active rows; 'auto' gathers exactly when that is a real cut
        if compute == "auto":
            compute = ("gathered" if self._scheduler.m_bound < n
                       else "masked")
        self._compute = compute
        self.ef = ef
        self._wire_dtype = _WIRE[hp.wire_dtype]
        # segmented packing bounds (live cluster count, largest cluster),
        # recomputed from the host DBSCAN labels at every recluster
        self._num_seg = n
        self._max_seg = 1

        # the state every round updates in place (see _write)
        self.g_opt_state = self._g_opt.init(self.g_params)
        # every client starts a round from the global params: a view
        self.params_s = C.broadcast_global(self.g_params, n)
        self.opt_s = adam(hp.lr).init(self.params_s, batch_dims=1)
        # per-client model state (the CNN's BatchNorm running statistics):
        # leaves (N, ...)
        self.state_s = (C.tree_map(lambda t: t.to(dev, torch.float32),
                                   C.stack_clients([state] * n))
                        if state else {})
        # the age plane: 'dense' keeps (N, d) ages and counts;
        # 'hierarchical' keys the ages by live cluster ((C, d), compacted
        # at every recluster) and logs each round's requests in a ring
        # that the host drains into _freq_host at its stops
        self._hier = hp.age_layout == "hierarchical"
        if self._hier:
            rage = hp.method == "rage_k"
            self.age = DeviceAgeState.create_hierarchical(
                d, n, log_len=hp.M if rage else 0,
                m_bound=self._scheduler.m_bound, k=hp.k,
                with_cost=hp.method == "cafe", device=dev)
            self._freq_host = np.zeros((n, d), np.int32) if rage else None
        else:
            self.age = DeviceAgeState.create(d, n, dev)
            self._freq_host = None
        self._log_seen = 0               # the host's drain watermark
        self._ids = torch.arange(n, device=dev)
        self.ef_mem = (torch.zeros((n, d), dtype=torch.float32, device=dev)
                       if ef else None)
        self.sched = SchedState.create(n, seed + 23, dev)
        self.round_idx = 0
        # the fault counts of an unfaulted round
        self._no_faults = torch.zeros(3, dtype=torch.int64, device=dev)

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

        # CUDA graphs of the round body, one per packing bound (the
        # reference's jit cache), with the rTop-k/random-k generator
        # registered (the sampler, the plans and the faults hash device
        # counters)
        self._graphs = GraphCache(dev, (self._gen,))

        # the every-M recluster: inline under run(), on a worker thread
        # under run_scanned(), joined before anything reads the labels.
        # Claims of the in-flight future (and the pool's shutdown) are
        # serialized: close() may race __del__ or a driver unwinding from
        # a chunk, and the worker's result is applied exactly once
        self._recluster_pool: ThreadPoolExecutor | None = None
        self._recluster_future = None
        self._recluster_lock = threading.Lock()
        # a worker failure, re-raised at every later consumer of the
        # labels (the first raise may be swallowed by __del__)
        self._recluster_exc: BaseException | None = None
        self._pinned = None              # host buffers of the snapshot
        # device->host bytes of the recluster inputs: the clustering
        # input (the (N, d) counts, or the drained log) and the age rows
        self.pull_bytes = {"clustering_input": 0, "age_rows": 0}
        self.recluster_s = 0.0           # host DBSCAN + merge wall
        self.recluster_wait_s = 0.0      # the part a driver blocked on

    @property
    def params(self) -> dict:
        """The global parameters as a tree of views."""
        return self._unflatten(self.g_params)

    def _compact(self, active: torch.Tensor) -> torch.Tensor:
        """(m_bound,) int64 ids of the active clients, ascending, padded
        with the sentinel N: the head of a stable sort of ``~active``
        (``torch.nonzero`` would sync the host)."""
        order = torch.sort((~active).to(torch.uint8), stable=True).indices
        order = order[:self._scheduler.m_bound]
        return torch.where(active.index_select(0, order), order, self.n)

    def _select(self, G: torch.Tensor, cands, act_ps: torch.Tensor,
                act_idx, faulted: bool = False):
        """Step 4 for the engine's method: (idx (N, k) int32, or None for
        dense; the SegmentedSelection of rage_k's segmented plane, or
        None). ``G`` holds the trained rows: all N (masked), or the
        ``act_idx`` slots (gathered; ``cands`` is in client layout either
        way). ``act_ps`` ((N,) bool) are the clients the PS hears from;
        ``faulted``: some trained clients are not among them. Updates the
        age state in place."""
        hp, n, d = self.hp, self.n, self.d
        act = None if self._full else act_ps
        rows = None if act_idx is None else act_idx.clamp(max=n - 1)

        def to_clients(idx_rows):
            return C.put_rows(torch.full((n, hp.k), d, dtype=torch.int32,
                                         device=self.device),
                              act_idx, idx_rows.to(torch.int32))
        seg = None
        if hp.method == "rage_k":
            if self._selection == "segmented":
                idx, age, seg = rage_select_segmented(
                    self.age, r=hp.r, k=hp.k, cands=cands, d=d,
                    num_segments=self._num_seg,
                    max_seg=min(self._max_seg, self._scheduler.m_bound),
                    disjoint=hp.disjoint_in_cluster, active=act)
            else:
                idx, age = rage_select(self.age, k=hp.k, cands=cands,
                                       disjoint=hp.disjoint_in_cluster,
                                       active=act)
            _write(self.age, age)
        elif hp.method == "cafe":
            # per-client cost-and-age selection: cluster_age doubles as the
            # per-client age rows (clusters stay singletons: no recluster
            # on this method) and freq (hierarchical: cost) holds the
            # cumulative cost; clients outside the round age with no
            # reset, no cost
            ca0 = self.age.cluster_age
            cost0 = self.age.freq if self.age.cost is None else self.age.cost
            if rows is None:
                idx, _, (ca, cost) = self._strategy.select_batch(
                    G, (ca0, cost0))
                if act is not None:
                    ca = torch.where(act.unsqueeze(1), ca, ca0 + 1)
                    cost = torch.where(act.unsqueeze(1), cost, cost0)
            else:
                idx_c, _, (ca_c, cost_c) = self._strategy.select_batch(
                    G, C.take_rows((ca0, cost0), rows))
                ca = C.put_rows(ca0 + 1, act_idx, ca_c)
                cost = C.put_rows(cost0, act_idx, cost_c)
                if faulted:
                    # quarantined and dropped rows: no reset, no cost
                    ca = torch.where(act.unsqueeze(1), ca, ca0 + 1)
                    cost = torch.where(act.unsqueeze(1), cost, cost0)
                idx = to_clients(idx_c)
            _write((ca0, cost0), (ca, cost))
        elif hp.method == "dense":
            return None, None
        elif hp.method in ("rtop_k", "random_k"):
            if rows is None:
                idx, _, _ = self._strategy.select_batch(G, self._gen)
            else:
                # the draw stays full-N: a client's draw depends only on
                # its id, not on who else took part
                idx = to_clients(self._strategy.select_rows(
                    G, self._gen, rows, n)[0])
        else:                                       # top_k, deterministic
            idx, _, _ = self._strategy.select_batch(G, ())
            if rows is not None:
                idx = to_clients(idx)
        # clients the PS does not hear from request nothing: sentinel-d
        # rows, set in this one place so that no method can forget them
        return torch.where(act_ps.unsqueeze(1), idx, d), seg

    def _log_requests(self, idx: torch.Tensor, active: torch.Tensor,
                      act_idx):
        """Append the round's requests to the hierarchical layout's ring:
        slot ``log_ptr % L`` takes the m_bound participants (``act_idx``
        when gathered, else the compacted active ids; padded slots hold
        the sentinel N and sentinel-d rows), and ``log_ptr`` advances. All
        on the device, at a device index: a replayed graph writes the
        slot of its own round."""
        n, d, age = self.n, self.d, self.age
        if act_idx is not None:
            mem = act_idx
        elif self._full:
            mem = self._ids
        else:
            mem = self._compact(active)
        rows = idx.index_select(0, mem.clamp(max=n - 1))
        rows = torch.where((mem < n).unsqueeze(1), rows, d)
        slot = (age.log_ptr % age.log_idx.shape[0]).to(torch.int64).view(1)
        age.log_idx.index_copy_(0, slot, rows.to(torch.int32).unsqueeze(0))
        age.log_mem.index_copy_(0, slot, mem.to(torch.int32).unsqueeze(0))
        age.log_ptr.add_(1)

    def _upload(self, G: torch.Tensor, idx, plan: RoundPlan, act_idx,
                ok: torch.Tensor):
        """What each trained row uploads, in wire form, late arrivals
        weighted: (vals (N, k) in client layout, or for dense the (N, d)
        sum's rows; sent (rows, d), each row's upload densely, for the
        error-feedback residual, or None without ef). ``ok`` (a bool per
        row of G) marks the rows whose upload lands: heard from by the
        PS, not a padded slot."""
        n, d = self.n, self.d
        gathered = act_idx is not None
        rows = act_idx.clamp(max=n - 1) if gathered else None
        if not self._full:
            # per row of G: stale, weight
            stale, weight = plan.staleness > 0, plan.weight
            if gathered:
                stale = stale.index_select(0, rows)
                weight = weight.index_select(0, rows)

        def weigh(v):
            v = v.to(self._wire_dtype).to(G.dtype)
            if self._full:
                return v
            # a stale arrival lands discounted; the fresh path stays
            # bitwise (the weight only where stale)
            v = torch.where(stale.unsqueeze(1),
                            v * weight.unsqueeze(1).to(G.dtype), v)
            return torch.where(ok.unsqueeze(1), v, 0.0)
        if idx is None:
            gw = weigh(G)
            if gathered:
                gw_n = C.put_rows(torch.zeros((n, d), dtype=G.dtype,
                                              device=self.device),
                                  act_idx, gw)
            else:
                gw_n = gw
            return gw_n, gw if self.ef else None
        idx_rows = idx.index_select(0, rows) if gathered else idx
        vals_r = weigh(G.gather(1, idx_rows.to(torch.int64).clamp(max=d - 1)))
        vals = (C.put_rows(torch.zeros(idx.shape, dtype=G.dtype,
                                       device=self.device), act_idx, vals_r)
                if gathered else vals_r)
        sent = None
        if self.ef:
            # sentinel-d picks land in a spare column that is cut off
            sent = torch.zeros((G.shape[0], d + 1), dtype=G.dtype,
                               device=self.device).scatter_(
                1, idx_rows.to(torch.int64), vals_r)[:, :d]
        return vals, sent

    def _crash(self, plan: RoundPlan):
        """The fault model's draws for this round (from the device round
        counter): ``plan`` with the crashed clients taken out of its
        active mask, and the wire faults (nan, inf, byz, drop masks and the
        crashed count) that act after the local phase."""
        crashed, nan, inf, byz, drop = self._faults.round_masks(
            self._fault_key, self.sched.rnd)
        n_crashed = (plan.active & crashed).sum()
        return (plan._replace(active=plan.active & ~crashed),
                (nan, inf, byz, drop, n_crashed))

    def _gate(self, G: torch.Tensor, act: torch.Tensor, act_idx, wire):
        """The wire faults and the validation gate on the trained rows G
        (all N, or the ``act_idx`` slots): (G as the PS receives it,
        act_ps, the clients it hears from, and the counts [quarantined,
        crashed, dropped])."""
        nan, inf, byz, drop, n_crashed = wire
        zero = n_crashed.new_zeros(())
        if not self._faults.any_wire:
            return G, act, torch.stack([zero, n_crashed, zero])
        rows = None if act_idx is None else act_idx.clamp(max=self.n - 1)

        def at_rows(m):
            return m if rows is None else m.index_select(0, rows)
        G = self._faults.corrupt(G, at_rows(nan), at_rows(inf), at_rows(byz))
        n_drop = (act & drop).sum()
        act_ps = act & ~drop
        n_quar = zero
        if self._quarantine:
            # finite everywhere and within the magnitude band: NaN and inf
            # rows fail the first, Byzantine-scaled rows the second
            row_ok = (torch.isfinite(G).all(dim=1)
                      & (G.abs().amax(dim=1) <= self._gate_bound))
            if rows is not None:
                row_ok = C.put_rows(torch.zeros(self.n, dtype=torch.bool,
                                                device=self.device),
                                    act_idx, row_ok)
            n_quar = (act_ps & ~row_ok).sum()
            act_ps = act_ps & row_ok
        return G, act_ps, torch.stack([n_quar, n_crashed, n_drop])

    def _round_impl(self, bx: torch.Tensor, by: torch.Tensor,
                    plan: RoundPlan | None = None, act_idx=None,
                    wire=None) -> dict:
        """One global round from the trained clients' batches (bx (rows,
        H, B, ...), by (rows, H, B): all N clients under masked compute,
        the ``act_idx`` slots under gathered). ``plan`` is the round's
        RoundPlan (None: the scheduler's); ``act_idx`` the compacted
        active ids (None: from the plan). Under faults, ``wire`` is what
        :meth:`_crash` returned with the crashed clients already out of
        ``plan``; None draws it here. Updates the engine state in place
        and returns the round's device tensors: losses (N,; NaN outside
        the round), the last-step gradients G of the trained rows (as the
        PS receives them), idx (N, k) (None for dense), the aggregated
        gradient g_sum (d,), the participation and age scalars, and
        ``faults``, the counts [quarantined, crashed, dropped]."""
        hp, n, d = self.hp, self.n, self.d
        if plan is None:
            plan = self._scheduler.plan(self.sched)
        if self._faults is not None and wire is None:
            plan, wire = self._crash(plan)
        gathered = self._compute == "gathered"
        if gathered and act_idx is None:
            act_idx = self._compact(plan.active)
        act = plan.active
        with record_function("local_phase"), strict_fp32():
            if gathered:
                rows = act_idx.clamp(max=n - 1)
                _, opt_c, state_c, G, cands_c, losses_c = self._local_phase(
                    C.broadcast_global(self.g_params, rows.shape[0]),
                    C.take_rows(self.opt_s, rows),
                    C.take_rows(self.state_s, rows), bx, by,
                    None if self.ef_mem is None
                    else self.ef_mem.index_select(0, rows))
                opt_s = C.put_rows(self.opt_s, act_idx, opt_c)
                state_s = C.put_rows(self.state_s, act_idx, state_c)
                # clients outside the round never trained: NaN losses
                losses = C.put_rows(torch.full((n,), float("nan"),
                                               device=self.device),
                                    act_idx, losses_c)
                cands = (None if cands_c is None else C.put_rows(
                    torch.zeros((n, hp.r), dtype=cands_c.dtype,
                                device=self.device), act_idx, cands_c))
            else:
                _, opt_s, state_s, G, cands, losses = self._local_phase(
                    self.params_s, self.opt_s, self.state_s, bx, by,
                    self.ef_mem)
                if not self._full:
                    # clients outside the round hold their local state
                    opt_s = C.where_rows(act, opt_s, self.opt_s)
                    state_s = C.where_rows(act, state_s, self.state_s)
                    losses = torch.where(act, losses, float("nan"))
            _write((self.opt_s, self.state_s), (opt_s, state_s))

        # the wire faults and the gate: act_ps, who the PS hears from
        if wire is None:
            act_ps, counts = act, self._no_faults
        else:
            with record_function("gate"):
                G, act_ps, counts = self._gate(G, act, act_idx, wire)
        faulted = act_ps is not act
        # per row of G: its upload lands (heard from, not a padded slot)
        if gathered:
            ok = act_idx < n
            if faulted:
                ok = ok & act_ps.index_select(0, act_idx.clamp(max=n - 1))
        else:
            ok = act_ps
        with record_function("select"):
            idx, seg = self._select(G, cands, act_ps, act_idx, faulted)
            if self.age.log_ptr is not None:
                self._log_requests(idx, act, act_idx)
            if self.age.upload_cost is not None:
                # the entries each client of the round uploads
                self.age.upload_cost.add_(
                    act.to(torch.int32) * (d if idx is None else hp.k))
        with record_function("aggregate"):
            vals, sent = self._upload(G, idx, plan, act_idx, ok)
            if idx is None:
                g_sum = vals.sum(0)
            elif seg is not None and self._agg_impl == "pallas":
                # the segmented layout feeds aggregation directly: padded
                # member slots and unpacked clients carry the sentinel
                # index d, which the kernel drops
                in_seg = (seg.members < n).unsqueeze(-1)
                seg_vals = torch.where(
                    in_seg,
                    vals[seg.members.clamp(max=n - 1).to(torch.int64)], 0.0)
                g_sum, _ = aggregate_sparse_fused(
                    seg.idx, seg_vals, torch.zeros(d, dtype=torch.int32,
                                                   device=self.device))
            else:
                g_sum = aggregate_sparse(idx, vals, d)
            if self.ef_mem is not None:
                # what a client did not send is its next residual
                # (optim.error_feedback.ef_update); clients the PS does not
                # hear from hold theirs (a corrupted row must not poison it)
                ef_rows = G - sent
                if gathered:
                    if faulted:
                        ef_rows = C.where_rows(ok, ef_rows, C.take_rows(
                            self.ef_mem, act_idx.clamp(max=n - 1)))
                    ef_rows = C.put_rows(self.ef_mem, act_idx, ef_rows)
                elif not self._full:
                    ef_rows = C.where_rows(act_ps, ef_rows, self.ef_mem)
                _write(self.ef_mem, ef_rows)
        with record_function("global_update"):
            # params_s views g_params, so the clients see the new params
            _write((self.g_params, self.g_opt_state),
                   apply_global(self._g_opt, g_sum, self.g_params,
                                self.g_opt_state))

        aoi = torch.where(act_ps, 0, self.sched.aoi + 1)
        _write(self.sched, self.sched._replace(rnd=self.sched.rnd + 1,
                                               aoi=aoi))
        live = torch.zeros(self.age.cluster_age.shape[0], dtype=torch.bool,
                           device=self.device).index_fill_(
            0, self.age.cluster_of.to(torch.int64), True)
        ca_live = torch.where(live.unsqueeze(1), self.age.cluster_age, 0)
        return {
            "losses": losses,
            "G": G,
            "idx": idx,
            "g_sum": g_sum,
            "n_active": act.sum(),
            "aoi_mean": aoi.to(torch.float32).mean(),
            "aoi_peak": aoi.max(),
            "age_mean": (ca_live.to(torch.float32).sum()
                         / (live.sum().to(torch.float32) * d)),
            "age_peak": ca_live.max(),
            "faults": counts,
        }

    def _round(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The round body both drivers run (and a graph captures): the
        plan (crashed clients out of it), the draw, :meth:`_round_impl`,
        and the metrics the host reads, packed into two flat device
        vectors: float32 [losses (N), aoi_mean, age_mean] and int64
        [n_active, aoi_peak, age_peak, n_quarantined, n_crashed,
        n_dropped, idx (N * k) (none for dense)]."""
        plan = self._scheduler.plan(self.sched)
        wire = None
        if self._faults is not None:
            plan, wire = self._crash(plan)
        act_idx = (self._compact(plan.active)
                   if self._compute == "gathered" else None)
        with record_function("draw"):
            if act_idx is not None:
                bx, by, samp = self._store.draw_gathered(
                    self._data, self.samp, self.hp.H, act_idx)
            else:
                bx, by, samp = self._store.draw(self._data, self.samp,
                                                self.hp.H)
                if not self._full:
                    # clients outside the round leave their stream as is
                    samp = C.where_rows(plan.active, samp, self.samp)
            _write(self.samp, samp)
        m = self._round_impl(bx, by, plan, act_idx, wire)
        with record_function("metrics"):
            f = torch.cat([m["losses"].to(torch.float32),
                           torch.stack([m["aoi_mean"], m["age_mean"]])])
            ints = [torch.stack([m["n_active"].to(torch.int64),
                                 m["aoi_peak"].to(torch.int64),
                                 m["age_peak"].to(torch.int64)]),
                    m["faults"].to(torch.int64)]
            if m["idx"] is not None:
                ints.append(m["idx"].reshape(-1).to(torch.int64))
            return f, torch.cat(ints)

    def _row(self, f: np.ndarray, i: np.ndarray) -> dict:
        """One round's host values from its two metric vectors."""
        n = self.n
        return {"losses": f[:n],
                "idx": (i[6:].reshape(n, -1).astype(np.int32)
                        if self.hp.method != "dense" else None),
                "n_active": int(i[0]),
                "aoi_mean": float(f[n]),
                "aoi_peak": int(i[1]),
                "age_mean": float(f[n + 1]),
                "age_peak": int(i[2]),
                "n_quarantined": int(i[3]),
                "n_crashed": int(i[4]),
                "n_dropped": int(i[5])}

    def step(self) -> dict:
        """Advance one global round, eagerly. Returns host values: losses
        (N,), idx (N, k) (None for dense), n_active, aoi_mean, aoi_peak,
        age_mean, age_peak."""
        self._recluster_join()
        t0 = time.perf_counter()
        f, i = self._round()
        with record_function("metrics"):
            out = self._row(f.cpu().numpy(), i.cpu().numpy())
        self.device_s += time.perf_counter() - t0
        self._bookkeep(out["n_active"])
        return out

    def _bookkeep(self, n_active: int):
        """Per-round host accounting shared by both drivers: the round
        count, the uplink of the clients that took part, and the every-M
        recluster (rAge-k)."""
        self.round_idx += 1
        self.cum_bytes += self._per_client_bytes * n_active
        if self.hp.method == "rage_k" and self.round_idx % self.hp.M == 0:
            with record_function("recluster"):
                self._recluster()

    # ------------------------------------------------------------------
    # the chunked driver: a CUDA graph of the round, replayed
    # ------------------------------------------------------------------
    def _graph_key(self):
        """What a graph of the round bakes in that can change: the age
        rows (hierarchical: C after a compaction) and the segmented
        packing bounds (rage_k segmented; the member bound is cut to the
        scheduler's m_bound, as :meth:`_select` packs)."""
        rows = self.age.cluster_age.shape[0]
        if self.hp.method == "rage_k" and self._selection == "segmented":
            return (rows, self._num_seg,
                    min(self._max_seg, self._scheduler.m_bound))
        return (rows,)

    def _chunk(self, rounds: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``rounds`` rounds with no host stop between them: on the card
        each one replay of the graph for the current packing bounds
        (captured at its first use), on the CPU the round body. Returns
        the rounds' metric vectors stacked on the device, (rounds, F)
        float32 and (rounds, I) int64."""
        self._recluster_join()
        return self._graphs.chunk(self._round, self._graph_key(), rounds)

    def _next_stop(self, end: int, eval_every: int, heatmap_at,
                   ckpt_every: int = 0) -> int:
        """First round after ``round_idx`` where the host must step in:
        the recluster (every M, rage_k), an eval, a heatmap, a
        checkpoint, or the end."""
        t = self.round_idx
        stops = [end, t + eval_every - t % eval_every]
        if self.hp.method == "rage_k":
            stops.append(t + self.hp.M - t % self.hp.M)
        if ckpt_every:
            stops.append(t + ckpt_every - t % ckpt_every)
        stops.extend(h for h in heatmap_at if h > t)
        return min(stops)

    def run_scanned(self, rounds: int, *, eval_every: int = 5,
                    heatmap_at=(), verbose: bool = False,
                    checkpointer=None, ckpt_every: int = 0,
                    result: FLResult | None = None) -> FLResult:
        """Drive ``rounds`` in chunks: the same rounds as :meth:`run`
        (bitwise), but the host touches the device once a chunk. Chunks
        end at the host's stops (the every-M recluster, eval, heatmap);
        the chunk's stacked metrics come down in one pull, and a
        recluster due at its end runs on a worker thread while the host
        drains them and evaluates. With ``checkpointer`` (an
        :class:`~repro_torch.checkpoint.AsyncCheckpointer`) chunks also
        end every ``ckpt_every`` rounds, where the state is saved."""
        t0 = time.time()
        res = result if result is not None else FLResult()
        end = self.round_idx + rounds
        while self.round_idx < end:
            T = (self._next_stop(end, eval_every, heatmap_at, ckpt_every)
                 - self.round_idx)
            td = time.perf_counter()
            fs, ints = self._chunk(T)
            # chunks end at the recluster rounds, so only the last round
            # of a chunk can trigger one: snapshot and submit it now, so
            # that it overlaps the pull and the bookkeeping below
            if (self.hp.method == "rage_k"
                    and (self.round_idx + T) % self.hp.M == 0):
                self._recluster_submit()
            fs, ints = fs.cpu().numpy(), ints.cpu().numpy()
            self.device_s += time.perf_counter() - td
            for j in range(T):
                row = self._row(fs[j], ints[j])
                self._bookkeep(row["n_active"])
                self._track(res, row)
            self._record(res, row["losses"], end=end, eval_every=eval_every,
                         heatmap_at=heatmap_at, verbose=verbose)
            self._maybe_save(checkpointer, ckpt_every, res)
        res.wall_s = time.time() - t0
        return res

    # ------------------------------------------------------------------
    # the every-M recluster
    # ------------------------------------------------------------------
    def _snapshot(self, src):
        """Host copies of the tensors ``src``, taken on the calling thread,
        so that no work enqueued later, which updates them in place,
        reaches them: on the card non-blocking copies into pinned buffers
        (kept while the shapes hold) and an event that marks them done.
        Returns (arrays, event or None)."""
        if self.device.type != "cuda":
            return [t.numpy().copy() for t in src], None
        if self._pinned is None or [h.shape for h in self._pinned] != [
                t.shape for t in src]:
            self._pinned = [torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True) for t in src]
        for h, t in zip(self._pinned, src):
            h.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return [h.numpy() for h in self._pinned], ready

    def _recluster_work(self):
        """The recluster's host work on a snapshot, as a callable for this
        thread or the worker: returns ((new cluster_age, labels), s).
        Under the hierarchical layout the log is drained first, here on
        the calling thread, so the worker reads a quiescent _freq_host
        (the next drain joins the worker first), and the new rows are
        the compact (C_new, d)."""
        age = self.age
        if self._hier:
            t0 = time.perf_counter()
            self._drain_freq_log()
            drain_s = time.perf_counter() - t0
            freq = self._freq_host
            (ca, cl), ready = self._snapshot((age.cluster_age,
                                              age.cluster_of))
            host = functools.partial(_recluster_host, compact=True)
        else:
            drain_s = 0.0
            (freq, ca, cl), ready = self._snapshot(
                (age.freq, age.cluster_age, age.cluster_of))
            self.pull_bytes["clustering_input"] += freq.nbytes
            host = _recluster_host
        self.pull_bytes["age_rows"] += ca.nbytes
        eps, min_pts = self.hp.eps, self.hp.min_pts

        def work():
            t0 = time.perf_counter()
            if ready is not None:
                ready.synchronize()
            return (host(freq, ca, cl, eps, min_pts),
                    drain_s + time.perf_counter() - t0)
        return work

    def _drain_freq_log(self):
        """Fold the log slots written since the last drain into
        _freq_host (hierarchical rAge-k; else nothing). Callers hold no
        recluster in flight: the worker reads _freq_host."""
        if self._freq_host is None:
            return
        seen = self._log_seen
        self._log_seen = drain_request_log(self.age, self._freq_host, seen,
                                           n=self.n, d=self.d)
        self.pull_bytes["clustering_input"] += (
            (self._log_seen - seen) * self.age.log_mem[0].numel()
            * (self.hp.k + 1) * 4)

    def _recluster_submit(self):
        """Start the every-M recluster on the worker thread (the chunked
        driver); :meth:`_recluster_join` applies it before anything reads
        the labels. Bitwise the inline path: the same snapshot, the same
        numpy math."""
        if self._recluster_future is not None:
            return
        if self._recluster_pool is None:
            self._recluster_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="recluster")
        self._recluster_future = self._recluster_pool.submit(
            self._recluster_work())

    def _recluster(self):
        """The every-M recluster. With a submission in flight (the chunked
        driver) nothing happens here: the first consumer of the new labels
        joins it. Else it runs inline, the host blocked throughout."""
        if self._recluster_future is not None:
            return
        (new_ca, labels), dt = self._recluster_work()()
        self.recluster_s += dt
        self.recluster_wait_s += dt
        self._apply_recluster(new_ca, labels)

    def _recluster_join(self):
        """Block on, and apply, the recluster in flight, if any. Every
        reader of the labels comes through here. The future is claimed
        under the lock, so concurrent callers apply it once; a past worker
        failure raises here at every later call."""
        with self._recluster_lock:
            fut, self._recluster_future = self._recluster_future, None
        if fut is None:
            if self._recluster_exc is not None:
                raise RuntimeError(
                    "recluster worker failed; cluster assignments are "
                    "stale") from self._recluster_exc
            return
        t0 = time.perf_counter()
        try:
            (new_ca, labels), work_s = fut.result()
        except BaseException as e:
            self._recluster_exc = e
            raise
        self.recluster_wait_s += time.perf_counter() - t0
        self.recluster_s += work_s
        self._apply_recluster(new_ca, labels)

    def _apply_recluster(self, new_ca: np.ndarray, labels: np.ndarray):
        """DBSCAN's rows and labels into the age state's own buffers; the
        packing bounds from the host labels. Hierarchical rows of a new
        count C_new take a new (C_new, d) buffer, and the old one goes
        with every graph that read it."""
        self._set_cluster_age(torch.from_numpy(new_ca))
        self.age.cluster_of.copy_(torch.from_numpy(labels.astype(np.int32)))
        self._num_seg = int(labels.max()) + 1
        self._max_seg = int(np.bincount(labels).max())

    def _set_cluster_age(self, rows: torch.Tensor):
        """Write ``rows`` into ``cluster_age`` in place when the shape
        holds; else replace the buffer and drop the graphs."""
        if rows.shape == self.age.cluster_age.shape:
            self.age.cluster_age.copy_(rows)
            return
        self._graphs.drop()
        self.age = self.age._replace(
            cluster_age=rows.to(self.device, torch.int32).contiguous())

    @property
    def recluster_hidden_s(self) -> float:
        """Host clustering wall hidden behind the chunk-boundary work."""
        return max(0.0, self.recluster_s - self.recluster_wait_s)

    def close(self):
        """Join any recluster in flight and release the worker thread.
        Idempotent; the engine stays usable (a later chunked recluster
        starts a new worker). A worker failure re-raises here too, after
        the thread is released."""
        try:
            self._recluster_join()
        finally:
            with self._recluster_lock:
                pool, self._recluster_pool = self._recluster_pool, None
            if pool is not None:
                pool.shutdown(wait=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    # checkpoint/resume
    # ------------------------------------------------------------------
    def state_tree(self) -> dict:
        """The whole round state as one tree: params, the global and
        per-client optimizer state, the model state, the age state in
        either layout (the log ring and ``log_ptr`` included), the ef
        memory, the sampler's cursors and counters, ``SchedState`` and
        the rTop-k/random-k generator's state (after any replays), plus
        the hierarchical
        layout's host counts. Joins any recluster in flight and drains
        the log first (a watermark move: the run's math is untouched)."""
        self._recluster_join()
        tree = {"carry": {
            "g_params": self.g_params, "g_opt_state": self.g_opt_state,
            "opt_s": self.opt_s, "state_s": self.state_s, "age": self.age,
            "ef_mem": self.ef_mem, "samp": self.samp, "sched": self.sched,
            "gen": {"select": self._gen.get_state()}}}
        if self._freq_host is not None:
            self._drain_freq_log()
            tree["freq_host"] = self._freq_host
        return tree

    def _extra_state(self) -> dict:
        return {"round_idx": self.round_idx, "cum_bytes": self.cum_bytes,
                "log_seen": self._log_seen, "num_seg": self._num_seg,
                "max_seg": self._max_seg}

    def save_state(self, checkpointer, result: FLResult | None = None):
        """Snapshot the round state into ``checkpointer`` (an
        ``AsyncCheckpointer``), the host scalars and the FLResult so far
        in its meta, so that a resumed driver reproduces the
        uninterrupted run's output."""
        tree = self.state_tree()     # first: its drain moves log_seen
        extra = self._extra_state()
        if result is not None:
            extra["result"] = _result_to_json(result)
        checkpointer.save(self.round_idx, tree, extra=extra)

    def load_state(self, source, step: int | None = None) -> FLResult:
        """Restore the newest good checkpoint under ``source`` (an
        ``AsyncCheckpointer`` or a directory), or ``step``. The engine
        must be built with the same config and seed. Buffers are written
        in place where the shapes match; hierarchical age rows of another
        count take a new buffer. Captured graphs are dropped (the next
        chunk captures anew). Returns the FLResult saved with the state
        (empty if none) for the driver to append to."""
        path = getattr(source, "path", source)
        tree, meta = load_checkpoint(path, self.state_tree(), step=step)
        self._graphs.drop()
        carry = tree["carry"]
        age = carry["age"]
        self._set_cluster_age(age.cluster_age)
        _write(self.age._replace(cluster_age=None),
               age._replace(cluster_age=None))
        for key in ("g_params", "g_opt_state", "opt_s", "state_s",
                    "ef_mem", "samp", "sched"):
            if carry[key] is not None:
                _write(getattr(self, key), carry[key])
        self._gen.set_state(carry["gen"]["select"])
        if "freq_host" in tree:
            self._freq_host = np.array(tree["freq_host"])
        ex = meta["extra"]
        self.round_idx = int(ex["round_idx"])
        self.cum_bytes = int(ex["cum_bytes"])
        self._log_seen = int(ex["log_seen"])
        self._num_seg = int(ex["num_seg"])
        self._max_seg = int(ex["max_seg"])
        return _result_from_json(ex.get("result"))

    def _maybe_save(self, checkpointer, ckpt_every: int, res: FLResult):
        """The drivers' checkpoint cadence: a save at every multiple of
        ``ckpt_every``, after the round's record."""
        if (checkpointer is not None and ckpt_every
                and self.round_idx % ckpt_every == 0):
            self.save_state(checkpointer, result=res)

    @property
    def cluster_of(self) -> np.ndarray:
        self._recluster_join()
        return self.age.cluster_of.cpu().numpy().astype(np.int64)

    @property
    def client_aoi(self) -> np.ndarray:
        """(N,) int64 rounds since the PS last heard from each client: the
        participation plane's client-level AoI."""
        return self.sched.aoi.cpu().numpy().astype(np.int64)

    @property
    def scheduler(self):
        return self._scheduler

    @property
    def freq_matrix(self) -> np.ndarray:
        """The cumulative (N, d) request-frequency matrix (eq.-3 inputs),
        in either layout: the device's counts (dense) or the host's
        (hierarchical, the log drained first), equal by construction.
        CAFe's cost rows stand in for it, as the reference stores them;
        methods that never request return zeros."""
        self._recluster_join()
        if self.age.freq is not None:
            return self.age.freq.cpu().numpy()
        if self._freq_host is not None:
            self._drain_freq_log()
            return self._freq_host.copy()
        if self.age.cost is not None:
            return self.age.cost.cpu().numpy()
        return np.zeros((self.n, self.d), np.int32)

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

    # ------------------------------------------------------------------
    # what both drivers record
    # ------------------------------------------------------------------
    @staticmethod
    def _track(res: FLResult, row: dict) -> None:
        """One round's per-round columns: requested indices and the
        participation and age metrics."""
        res.requested.append(row["idx"])
        for key in ("n_active", "aoi_mean", "aoi_peak", "age_mean",
                    "age_peak", "n_quarantined", "n_crashed", "n_dropped"):
            getattr(res, key).append(row[key])

    def _record(self, res: FLResult, losses, *, end: int, eval_every: int,
                heatmap_at, verbose: bool) -> None:
        """Eval, record and heatmap at the current round: the shared tail
        of both drivers (after each step, at each chunk's end; chunks end
        on the same rounds). ``losses`` is this round's (N,) vector."""
        t = self.round_idx
        if t % eval_every == 0 or t == end:
            acc = self.eval_acc()
            loss = float(np.nanmean(losses))
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

    def run(self, rounds: int, *, eval_every: int = 5, heatmap_at=(),
            verbose: bool = False, checkpointer=None, ckpt_every: int = 0,
            result: FLResult | None = None) -> FLResult:
        """Drive ``rounds`` through :meth:`step`, one host pull a round;
        with ``checkpointer``, the state is saved every ``ckpt_every``
        rounds."""
        t0 = time.time()
        res = result if result is not None else FLResult()
        end = self.round_idx + rounds
        while self.round_idx < end:
            m = self.step()
            self._track(res, m)
            self._record(res, m["losses"], end=end, eval_every=eval_every,
                         heatmap_at=heatmap_at, verbose=verbose)
            self._maybe_save(checkpointer, ckpt_every, res)
        res.wall_s = time.time() - t0
        return res
