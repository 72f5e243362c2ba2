"""The async parameter-server service: the port of ``repro.fl.service``,
event-driven buffered aggregation with age-decayed staleness.

The engine's rounds are lockstep: the PS waits for every solicited
client, so its rate is set by the slowest. Here the PS runs on: each
client's update lands when it is done, in virtual time from the
deterministic per-client latency model (``fl.latency.LatencyModel``, the
same hashed lognormal draws that price the synchronous deadline plan).
One event:

1. pops the in-flight client with the earliest completion time (ties to
   the lowest id) and advances the virtual clock;
2. replays that client's local phase (H steps, ``draw_one`` batches)
   against the parameter snapshot of the version it was sent, read from a
   ring of the last V snapshots, staleness clipped at V-1;
3. under faults, draws the dispatch's fate (``FaultModel.dispatch_fate``
   keyed by (client, dispatch count)), corrupts the update and applies
   the PS's validation gate; a crashed dispatch holds the client's rows;
4. selects the k upload coordinates: ``solicit='report'``, the paper's
   plane, the top-r report (on the card the report's two kernels on a
   (1, d) row) filtered by cluster age, disjoint within the flush window;
   ``'dispatch'``, the k largest-|g| of the r stalest coordinates the PS
   solicited at dispatch time;
5. lands the update in a FedBuff buffer, weighted by 1/(1+s)^eta, and
   applies eq. (2) to the client's cluster row; records the request
   (dense: the (N, d) counts; hierarchical: one log slot);
6. at K landings flushes: one global step on the buffer, version + 1,
   the new snapshot into ring slot ``version % V``, buffer and window
   reset;
7. re-dispatches the client at ``clock + dispatch_s * backoff^retries``
   (dispatch mode: re-solicits the cluster's r stalest coordinates
   outside the other in-flight solicitations).

The state is a fixed set of device buffers that an event updates in
place (``engine._write``), so that on the card each event is one replay
of a CUDA graph of the event body, keyed as the engine's (the age rows,
``taken``'s and ``inflight``'s rows): a chunk of events has no host sync.
A graph cannot branch, so the flush's global step is computed every
event and committed by ``torch.where`` (the committed bits are the
engine's ``apply_global``'s; Adam's step advances only on a flush). On
the CPU each event runs eagerly.

Degenerate pin: at K = N, equal latencies (hetero = jitter = 0) and V = 1
the event loop is the synchronous full-participation engine: everyone
lands once a window in client-id order against the current params, and
the flush is the round's global step (bitwise on the CPU,
tests/test_torch_service.py). Every M aggregations the host reclusters
with the engine's path; only metrics leave the device, once a chunk.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint.io import load_checkpoint
from repro_torch.configs.base import RAgeKConfig
from repro_torch.core.compression import (bytes_per_index, bytes_per_round,
                                          downlink_bytes_per_round)
from repro_torch.core.strategies import CANDIDATE_IMPLS, _stable_topk
from repro_torch.data.pipeline import DeviceShardStore
from repro_torch.device import resolve, strict_fp32
from repro_torch.fl import client as C
from repro_torch.fl.engine import (_WIRE, DeviceAgeState, _build_model,
                                   _recluster_host, _write, apply_global,
                                   build_eval_sets, drain_request_log,
                                   member_age_row, select_member_topk)
from repro_torch.fl.graphs import GraphCache
from repro_torch.fl.latency import LatencyModel
from repro_torch.optim.optimizers import adam, sgd

SOLICIT_MODES = ("report", "dispatch")
# chunks of K events with no flush before a faulted run gives up
STALL_CHUNKS = 1000


class ServiceState(NamedTuple):
    """The async PS's whole mutable state, on the device. A chunk's end
    leaves it as the next chunk reads it, so ``run_async(T)`` is
    invariant to chunking.

    clock:        () float32, virtual time of the last landing.
    next_done:    (N,) float32 in-flight completion times.
    sent_version: (N,) int32 model version each client was sent.
    n_dispatch:   (N,) int32 dispatches per client (the latency and fault
                  counter).
    version:      () int32 global model version.
    ring:         (V, d) float32: slot v % V holds version v's params.
    g_params, g_opt_state: the global model (flat) and its optimizer.
    buf:          (d,) float32 FedBuff accumulator (staleness-weighted).
    buf_count:    () int32 updates landed since the last flush.
    taken:        (C_rows, d) bool in-window disjointness per cluster row
                  (report mode; reset at every flush); N rows dense, the
                  live cluster count hierarchical.
    solicited:    (N, r) int64, dispatch mode: the coordinates the PS
                  solicited from each client at its dispatch ((N, 1)
                  otherwise).
    inflight:     (C_rows, d) bool, dispatch mode: coordinates solicited
                  from any in-flight member, per cluster row ((1, d)
                  otherwise).
    age:          DeviceAgeState: cluster ages, counts or log, labels.
    opt_s, state_s, samp: per-client optimizer, model state (BatchNorm)
                  and sampler rows; only the landing client's advance.
    key:          () int64 latency key (the service's seed).
    n_retry:      (N,) int32 consecutive failed dispatches per client
                  (the re-solicitation backoff's exponent; 0 after a
                  clean landing).
    """

    clock: torch.Tensor
    next_done: torch.Tensor
    sent_version: torch.Tensor
    n_dispatch: torch.Tensor
    version: torch.Tensor
    ring: torch.Tensor
    g_params: torch.Tensor
    g_opt_state: Any
    buf: torch.Tensor
    buf_count: torch.Tensor
    taken: torch.Tensor
    solicited: torch.Tensor
    inflight: torch.Tensor
    age: DeviceAgeState
    opt_s: Any
    state_s: Any
    samp: Any
    key: torch.Tensor
    n_retry: torch.Tensor


@dataclass
class ServiceResult:
    """Per-aggregation curves and per-event traces of one service run."""

    rounds: list = field(default_factory=list)       # aggregation index
    loss: list = field(default_factory=list)         # window mean loss
    acc: list = field(default_factory=list)
    uplink_bytes: list = field(default_factory=list)   # cumulative
    downlink_bytes: list = field(default_factory=list) # cumulative
    clock: list = field(default_factory=list)        # virtual s at eval
    cluster_labels: list = field(default_factory=list)
    # per event (one entry per landing, in event order)
    clients: list = field(default_factory=list)      # landing client id
    staleness: list = field(default_factory=list)    # versions late
    event_clock: list = field(default_factory=list)
    requested: list = field(default_factory=list)    # (k,) idx per event
    # fault flags per event (all False without faults): quarantined by
    # the gate, crashed dispatches, wire-dropped updates, retries
    quarantined: list = field(default_factory=list)
    crashed: list = field(default_factory=list)
    dropped: list = field(default_factory=list)
    retried: list = field(default_factory=list)
    wall_s: float = 0.0

    def staleness_hist(self) -> dict:
        vals, counts = np.unique(np.asarray(self.staleness, np.int64),
                                 return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, counts)}

    def summary(self) -> dict:
        virtual_s = float(self.event_clock[-1]) if self.event_clock else 0.0
        aggs = self.rounds[-1] if self.rounds else 0
        return {
            "aggregations": aggs,
            "events": len(self.clients),
            "virtual_s": virtual_s,
            "aggs_per_virtual_s": (aggs / virtual_s if virtual_s else 0.0),
            "final_acc": self.acc[-1] if self.acc else float("nan"),
            "final_loss": self.loss[-1] if self.loss else float("nan"),
            "total_uplink_mb": (self.uplink_bytes[-1] / 2**20
                                if self.uplink_bytes else 0.0),
            "total_downlink_mb": (self.downlink_bytes[-1] / 2**20
                                  if self.downlink_bytes else 0.0),
            "staleness_mean": (float(np.mean(self.staleness))
                               if self.staleness else 0.0),
            "staleness_max": (int(max(self.staleness))
                              if self.staleness else 0),
            "total_quarantined": int(sum(self.quarantined)),
            "total_crashed": int(sum(self.crashed)),
            "total_dropped": int(sum(self.dropped)),
            "total_retried": int(sum(self.retried)),
            "wall_s": self.wall_s,
        }


def _hold(flag: torch.Tensor, old, new):
    """``old`` where the one-element bool ``flag`` is set, else ``new``,
    leaf by leaf over trees of equal structure."""
    return C.map_rows(lambda a, b: torch.where(
        flag.reshape((1,) * a.ndim), a, b), old, new)


class AsyncService:
    """The engine as a continuously running server, in virtual time.

    Usage::

        svc = AsyncService("mlp", shards, test, hp, seed=0,
                           latency=LatencyModel(len(shards), hetero=1.0))
        res = svc.run_async(aggregations=40, eval_every=5)

    ``hp.buffer_k`` (K; 0 -> N), ``hp.staleness_eta`` (eta of the
    1/(1+s)^eta discount) and ``hp.version_window`` (V) come from
    :class:`RAgeKConfig`; ``latency=None`` is the equal-latency model
    (every dispatch takes 1.0 virtual s), which with K = N and V = 1 is
    the synchronous engine. ``device=None`` means the card and raises
    without one. ``params``/``state`` replace the seeded initial weights
    and model state, as the engine's. ``faults`` (a ``FaultModel`` over
    the same N), ``quarantine`` and ``gate_bound`` as the engine's;
    ``max_retries`` caps the backoff exponent and ``backoff`` is its base.
    """

    def __init__(self, kind: str, shards: list, test: tuple,
                 hp: RAgeKConfig, *, seed: int = 0, device=None,
                 params=None, state=None,
                 latency: LatencyModel | None = None,
                 solicit: str = "report", global_opt: str = "adam",
                 faults=None, quarantine: bool = True,
                 gate_bound: float = 1e4, max_retries: int = 3,
                 backoff: float = 2.0):
        if hp.method != "rage_k":
            raise ValueError(
                f"AsyncService runs the rAge-k plane; method "
                f"{hp.method!r} has no age state to solicit from "
                f"(use FederatedEngine)")
        if solicit not in SOLICIT_MODES:
            raise ValueError(f"solicit must be one of {SOLICIT_MODES}, "
                             f"got {solicit!r}")
        if hp.candidates not in CANDIDATE_IMPLS:
            raise ValueError(f"candidates must be one of "
                             f"{CANDIDATE_IMPLS}, got {hp.candidates!r}")
        if hp.r < hp.k:
            raise ValueError(f"need r >= k (got r={hp.r}, k={hp.k})")
        if hp.version_window < 1:
            raise ValueError(f"version_window (V) must be >= 1, got "
                             f"{hp.version_window}")
        if hp.buffer_k < 0 or hp.buffer_k > len(shards):
            raise ValueError(
                f"buffer_k must be in [0, N={len(shards)}] (0 -> N), "
                f"got {hp.buffer_k}")
        if hp.staleness_eta < 0:
            raise ValueError(f"staleness_eta must be >= 0, got "
                             f"{hp.staleness_eta}")
        if global_opt not in ("adam", "sgd"):
            raise ValueError(f"global_opt must be 'adam' or 'sgd', got "
                             f"{global_opt!r}")
        self.device = dev = resolve(device)
        self.hp = hp
        self.kind = kind
        self.n = n = len(shards)
        self.seed = seed
        self.K = hp.buffer_k or n
        self.V = V = hp.version_window
        self.eta = float(hp.staleness_eta)
        self._solicit = solicit
        self._latency = latency if latency is not None else LatencyModel(
            n, hetero=0.0, jitter=0.0, seed=seed, device=dev)
        if self._latency.n != n:
            raise ValueError(f"latency model is for n={self._latency.n} "
                             f"clients, engine has N={n}")
        # the fault plane: per-dispatch fates, the PS's validation gate,
        # and re-solicitation with a virtual-clock backoff on failures
        if faults is not None and faults.n != n:
            raise ValueError(f"FaultModel.n={faults.n} != {n} clients")
        if max_retries < 0 or backoff < 1.0:
            raise ValueError(f"need max_retries >= 0 and backoff >= 1 "
                             f"(got {max_retries}, {backoff})")
        self._faults = faults if faults is not None and faults.any else None
        self._fault_key = seed + 77
        self._quarantine = bool(quarantine)
        self._gate_bound = float(gate_bound)
        self._max_retries = int(max_retries)
        self._backoff = float(backoff)

        init, state0, apply_loss, self._predict = _build_model(
            kind, torch.Generator().manual_seed(seed), dev)
        params = init if params is None else params
        state0 = state0 if state is None else state
        self._unflatten = C.unflattener(params)
        g_params = C.flatten_tree(params).to(device=dev, dtype=torch.float32)
        self.d = d = g_params.shape[0]
        # report mode takes the top-r report in the client phase's tail
        self._client_phase = C.make_client_phase(
            apply_loss, self._unflatten, hp.lr,
            report_r=hp.r if solicit == "report" else None,
            report_impl=hp.candidates)
        self._g_opt = adam(hp.lr) if global_opt == "adam" else sgd(hp.lr)
        self._wire_dtype = _WIRE[hp.wire_dtype]

        # the age plane: the hierarchical log takes one slot a landing, so
        # its ring spans a recluster window of M aggregations of K
        self._hier = hp.age_layout == "hierarchical"
        if self._hier:
            age0 = DeviceAgeState.create_hierarchical(
                d, n, log_len=hp.M * self.K, m_bound=1, k=hp.k, device=dev)
            self._freq_host = np.zeros((n, d), np.int32)
        else:
            age0 = DeviceAgeState.create(d, n, dev)
            self._freq_host = None
        self._log_seen = 0
        dispatch = solicit == "dispatch"
        key = torch.full((), seed, dtype=torch.int64, device=dev)
        ids = torch.arange(n, device=dev)
        zeros_i = torch.zeros(n, dtype=torch.int32, device=dev)
        self._store = DeviceShardStore(shards, hp.batch_size,
                                       seed=seed + 17, device=dev)
        self._data = self._store.data
        self.state = ServiceState(
            clock=torch.zeros((), device=dev),
            next_done=self._latency.dispatch_s(key, ids, zeros_i).to(
                torch.float32),
            sent_version=zeros_i.clone(),
            n_dispatch=zeros_i.clone(),
            version=torch.zeros((), dtype=torch.int32, device=dev),
            ring=g_params.unsqueeze(0).repeat(V, 1),
            g_params=g_params,
            g_opt_state=self._g_opt.init(g_params),
            buf=torch.zeros(d, device=dev),
            buf_count=torch.zeros((), dtype=torch.int32, device=dev),
            taken=torch.zeros((n, d), dtype=torch.bool, device=dev),
            solicited=torch.zeros((n, hp.r if dispatch else 1),
                                  dtype=torch.int64, device=dev),
            inflight=torch.zeros((n if dispatch else 1, d),
                                 dtype=torch.bool, device=dev),
            age=age0,
            opt_s=adam(hp.lr).init(g_params.unsqueeze(0).repeat(n, 1),
                                   batch_dims=1),
            state_s=(C.tree_map(lambda t: t.to(dev, torch.float32),
                                C.stack_clients([state0] * n))
                     if state0 else {}),
            samp=self._store.init_state(),
            key=key,
            n_retry=zeros_i.clone())
        self._true = torch.ones((), dtype=torch.bool, device=dev)
        if dispatch:
            self._initial_solicitations()
        self._eval_sets = build_eval_sets(shards, test, device=dev)

        # CUDA graphs of the event body, one per row count of its buffers
        self._graphs = GraphCache(dev)

        # wire accounting (per landing / per dispatch)
        ib = bytes_per_index(d)
        if solicit == "report":
            # the paper's uplink (k entries + the r-candidate report) and
            # the downlink of the PS's k-requested list
            self._uplink_per_landing = bytes_per_round(
                hp.k, d, wire_dtype=hp.wire_dtype) + hp.r * ib
            self._downlink_per_dispatch = downlink_bytes_per_round(hp.k, d)
        else:
            # the solicitation (r stalest indices) goes down at dispatch;
            # only k entries come up
            self._uplink_per_landing = bytes_per_round(
                hp.k, d, wire_dtype=hp.wire_dtype)
            self._downlink_per_dispatch = downlink_bytes_per_round(hp.r, d)
        self.cum_uplink = 0
        self.cum_downlink = self._downlink_per_dispatch * n  # t = 0 fleet
        self.aggs_done = 0
        self.events_done = 0
        self.device_s = 0.0
        self.recluster_s = 0.0

    # ------------------------------------------------------------------
    # the event body
    # ------------------------------------------------------------------
    def _resolicit(self, solicited, inflight, cluster_age, i, cl):
        """Dispatch mode: solicit the r stalest coordinates of client
        ``i``'s cluster row ((1,) ids), outside the cluster's other
        in-flight solicitations: (solicited, inflight) updated."""
        r = self.hp.r
        row = torch.where(inflight.index_select(0, cl)[0], -1,
                          cluster_age.index_select(0, cl)[0])
        sol = _stable_topk(row, r)
        return (solicited.index_copy(0, i, sol.unsqueeze(0)),
                inflight.index_put((cl.expand(r), sol), self._true))

    def _initial_solicitations(self):
        """Dispatch mode at t = 0: every client's solicitation in client-id
        order, each disjoint from the ones before it in its cluster."""
        st = self.state
        solicited, inflight = st.solicited, st.inflight
        for i in range(self.n):
            ii = torch.tensor([i], device=self.device)
            cl = st.age.cluster_of.index_select(0, ii).to(torch.int64)
            solicited, inflight = self._resolicit(
                solicited, inflight, st.age.cluster_age, ii, cl)
        _write((st.solicited, st.inflight), (solicited, inflight))

    def _event(self) -> tuple[torch.Tensor, torch.Tensor]:
        """One landing: land, buffer, maybe flush, re-dispatch, all in
        place on ``self.state``. Returns the event's metrics as two
        device vectors: float32 [loss, clock] and int64 [client,
        staleness, version, flushed, quarantined, crashed, dropped,
        retried, idx (k)]."""
        hp, st = self.hp, self.state
        V, K, d = self.V, self.K, self.d
        age = st.age

        # 1. the earliest in-flight completion (ties to the lowest id)
        i = torch.argmin(st.next_done).reshape(1)
        t = st.next_done.index_select(0, i)

        # 2. the local phase against the snapshot client i was sent, its
        #    staleness clipped to the ring's memory
        version = st.version.reshape(1)
        eff_v = torch.maximum(st.sent_version.index_select(0, i),
                              version - (V - 1))
        s = version - eff_v
        params_i = st.ring.index_select(0, (eff_v % V).to(torch.int64))
        bx, by, samp = self._store.draw_one(self._data, st.samp, hp.H, i)
        opt_i = C.take_rows(st.opt_s, i)
        state_i = C.take_rows(st.state_s, i)
        with strict_fp32():
            _, opt_new, state_new, g, cand, loss = self._client_phase(
                params_i, opt_i, state_i, bx, by)

        # 3. the dispatch's fault fate, the corruption and the gate
        good = quar = crashed = dropped = None
        if self._faults is not None:
            crashed, f_nan, f_inf, f_byz, f_drop = self._faults.dispatch_fate(
                self._fault_key, i, st.n_dispatch.index_select(0, i))
            g = self._faults.corrupt(g, f_nan, f_inf, f_byz)
            row_ok = (torch.isfinite(g).all(dim=1)
                      & (g.abs().amax(dim=1) <= self._gate_bound))
            good = ~crashed & ~f_drop
            dropped = ~crashed & f_drop
            quar = good & ~row_ok if self._quarantine else good & False
            if self._quarantine:
                good = good & row_ok
            # a crashed dispatch never ran: the client's optimizer, model
            # state and sampler rows hold, its data stream unconsumed
            opt_new = _hold(crashed, opt_i, opt_new)
            state_new = _hold(crashed, state_i, state_new)
            samp = _hold(crashed, st.samp, samp)
            loss = torch.where(crashed, float("nan"), loss)
        opt_s = C.put_rows(st.opt_s, i, opt_new)
        state_s = C.put_rows(st.state_s, i, state_new)

        # 4. the upload's coordinates
        cl = age.cluster_of.index_select(0, i).to(torch.int64)
        taken, solicited, inflight = st.taken, st.solicited, st.inflight
        if self._solicit == "report":
            idx = select_member_topk(
                age.cluster_age, taken if hp.disjoint_in_cluster else None,
                cand[0].to(torch.int64), cl, k=hp.k)
            if hp.disjoint_in_cluster:
                taken = taken.index_put((cl.expand(hp.k), idx), self._true)
        else:
            # the client uploads the k largest-|g| of its r solicited
            # coordinates, which are then free for the cluster's next
            # dispatches (solicitations are disjoint: only i marks them)
            sub = solicited.index_select(0, i)[0]
            idx = sub.gather(0, _stable_topk(g[0].abs().gather(0, sub),
                                             hp.k))
            inflight = inflight.index_put((cl.expand(hp.r), sub),
                                          ~self._true)
        if good is not None:
            # a failed landing leaves the disjointness window as it was
            taken = torch.where(good, taken, st.taken)

        # 5. land in the buffer, staleness-discounted; eq. (2) on the
        #    cluster row; the request recorded
        vals = g[0].gather(0, idx).to(self._wire_dtype).to(g.dtype)
        w = torch.pow(1.0 + s.to(torch.float32), -self.eta)
        vals = torch.where(s > 0, vals * w, vals)
        if good is not None:
            vals = torch.where(good, vals, 0.0)
        buf = st.buf.index_add(0, idx, vals)
        buf_count = st.buf_count + (1 if good is None
                                    else good.to(torch.int32)[0])
        row = age.cluster_age.index_select(0, cl)[0]
        new_row = member_age_row(row, idx)
        if good is not None:
            new_row = torch.where(good, new_row, row + 1)
        ca = age.cluster_age.index_copy(0, cl, new_row.unsqueeze(0))
        if age.freq is not None:
            hit = (torch.ones_like(idx, dtype=torch.int32) if good is None
                   else good.to(torch.int32).expand(hp.k))
            age_new = age._replace(cluster_age=ca, freq=age.freq.index_put(
                (i.expand(hp.k), idx), hit, accumulate=True))
        else:
            # hierarchical: one log slot (m_bound 1) and the upload cost;
            # column d is the drain's "no request"
            slot = (age.log_ptr % age.log_idx.shape[0]).to(
                torch.int64).reshape(1)
            log_val = idx.to(torch.int32)
            cost = torch.full((1,), hp.k, dtype=torch.int32,
                              device=self.device)
            if good is not None:
                log_val = torch.where(good, log_val, d)
                cost = torch.where(crashed, 0, cost)
            age_new = age._replace(
                cluster_age=ca,
                log_idx=age.log_idx.index_copy(
                    0, slot, log_val.view(1, 1, -1)),
                log_mem=age.log_mem.index_copy(
                    0, slot, i.to(torch.int32).view(1, 1)),
                log_ptr=age.log_ptr + 1,
                upload_cost=age.upload_cost.index_add(0, i, cost))

        # 6. the flush at K landings: the global step is computed every
        #    event and committed where the buffer is full
        flush = buf_count >= K
        version_new = st.version + flush.to(torch.int32)
        new_p, new_o = apply_global(self._g_opt, buf, st.g_params,
                                    st.g_opt_state)
        g_params = torch.where(flush, new_p, st.g_params)
        g_opt_state = _hold(flush, new_o, st.g_opt_state)
        slot = (version_new % V).to(torch.int64).reshape(1)
        ring = st.ring.index_copy(0, slot, torch.where(
            flush, new_p, st.ring.index_select(0, slot)[0]).unsqueeze(0))
        buf = torch.where(flush, 0.0, buf)
        taken = torch.where(flush, False, taken)
        buf_count = torch.where(flush, 0, buf_count)

        # 7. re-dispatch with the post-flush version; a failed dispatch
        #    backs off in virtual time (latency x backoff^retries, the
        #    exponent capped), a good landing resets its retry count
        nd = st.n_dispatch.index_select(0, i) + 1
        lat = self._latency.dispatch_s(st.key, i, nd).to(torch.float32)
        n_retry = st.n_retry
        if good is not None:
            retry = torch.where(good, 0, torch.clamp(
                n_retry.index_select(0, i) + 1, max=self._max_retries))
            lat = lat * torch.pow(torch.full_like(lat, self._backoff),
                                  retry.to(torch.float32))
            n_retry = n_retry.index_copy(0, i, retry.to(torch.int32))
        if self._solicit == "dispatch":
            solicited, inflight = self._resolicit(solicited, inflight, ca,
                                                  i, cl)

        _write(st, ServiceState(
            clock=t[0],
            next_done=st.next_done.index_copy(0, i, t + lat),
            sent_version=st.sent_version.index_copy(0, i,
                                                    version_new.reshape(1)),
            n_dispatch=st.n_dispatch.index_copy(0, i, nd),
            version=version_new,
            ring=ring, g_params=g_params, g_opt_state=g_opt_state,
            buf=buf, buf_count=buf_count, taken=taken,
            solicited=solicited, inflight=inflight, age=age_new,
            opt_s=opt_s, state_s=state_s, samp=samp, key=st.key,
            n_retry=n_retry))
        off = torch.zeros(1, dtype=torch.bool, device=self.device)
        flags = ([off] * 4 if good is None
                 else [quar, crashed, dropped, ~good])
        f = torch.cat([loss.to(torch.float32), t])
        ints = torch.cat([i, s.to(torch.int64), version_new.reshape(1).to(
            torch.int64), flush.reshape(1).to(torch.int64)]
            + [m.to(torch.int64) for m in flags] + [idx.to(torch.int64)])
        return f, ints

    # ------------------------------------------------------------------
    # chunks of events: CUDA graph replays on the card
    # ------------------------------------------------------------------
    def _graph_key(self):
        """What a graph of the event bakes in that can change: the row
        counts of the age rows, ``taken`` and ``inflight``."""
        st = self.state
        return (st.age.cluster_age.shape[0], st.taken.shape[0],
                st.inflight.shape[0])

    def _chunk(self, n_events: int, *, eager: bool = False):
        """``n_events`` events with no host sync: on the card each one
        replay of the graph for the current key (captured at first use;
        ``eager`` runs the body eagerly instead), on the CPU the body
        eagerly. Returns the stacked metric vectors on the device,
        (n_events, 2) float32 and (n_events, 8 + k) int64."""
        return self._graphs.chunk(self._event, self._graph_key(), n_events,
                                  eager=eager)

    def _advance(self, n_events: int, *, eager: bool = False) -> dict:
        """Run ``n_events`` events as one chunk and return their metrics
        as numpy: loss, clock, client, staleness, version, flushed,
        quarantined, crashed, dropped, retried ((n_events,) each) and idx
        (n_events, k). Any chunking of the same event count replays the
        same events."""
        t0 = time.perf_counter()
        f, i = self._chunk(n_events, eager=eager)
        f, i = f.cpu().numpy(), i.cpu().numpy()
        self.device_s += time.perf_counter() - t0
        self.events_done += n_events
        out = {"loss": f[:, 0], "clock": f[:, 1],
               "idx": i[:, 8:].astype(np.int32)}
        for j, name in enumerate(("client", "staleness", "version")):
            out[name] = i[:, j].astype(np.int32)
        for j, name in enumerate(("flushed", "quarantined", "crashed",
                                  "dropped", "retried")):
            out[name] = i[:, 3 + j].astype(bool)
        return out

    # ------------------------------------------------------------------
    # the host's control plane
    # ------------------------------------------------------------------
    def _recluster(self):
        """The every-M-aggregations DBSCAN, the engine's host path (eq.
        (3) similarity, DBSCAN, age merge). It runs at a flush boundary,
        where the window is empty; hierarchical rows of a new count take
        new buffers (the age rows and ``taken``), and in dispatch mode
        the in-flight marks are re-keyed to the new cluster rows."""
        t0 = time.perf_counter()
        st = self.state
        if self._hier:
            self._drain_log()
            freq = self._freq_host
        else:
            freq = st.age.freq.cpu().numpy()
        new_ca, labels = _recluster_host(
            freq, st.age.cluster_age.cpu().numpy(),
            st.age.cluster_of.cpu().numpy(), self.hp.eps, self.hp.min_pts,
            compact=self._hier)
        rows = new_ca.shape[0]
        st.age.cluster_of.copy_(torch.from_numpy(labels.astype(np.int32)))
        new = {}
        if rows != st.age.cluster_age.shape[0]:
            new["age"] = st.age._replace(cluster_age=torch.from_numpy(
                new_ca).to(self.device))
        else:
            st.age.cluster_age.copy_(torch.from_numpy(new_ca))
        if self._hier and st.taken.shape[0] != rows:
            new["taken"] = torch.zeros((rows, self.d), dtype=torch.bool,
                                       device=self.device)
        if self._solicit == "dispatch":
            cl = st.age.cluster_of.to(torch.int64)
            inflight = torch.zeros((rows if self._hier else self.n, self.d),
                                   dtype=torch.bool, device=self.device)
            inflight[cl.unsqueeze(1).expand(-1, self.hp.r),
                     st.solicited] = True
            if inflight.shape == st.inflight.shape:
                st.inflight.copy_(inflight)
            else:
                new["inflight"] = inflight
        if new:
            self._graphs.drop()
            self.state = st._replace(**new)
        self.recluster_s += time.perf_counter() - t0

    def _next_stop(self, end: int, eval_every: int,
                   ckpt_every: int = 0) -> int:
        """Next aggregation count where the host steps in: the recluster
        (every M), an eval, a checkpoint, or the end."""
        a = self.aggs_done
        stops = [end, a + eval_every - a % eval_every,
                 a + self.hp.M - a % self.hp.M]
        if ckpt_every:
            stops.append(a + ckpt_every - a % ckpt_every)
        return min(stops)

    # ------------------------------------------------------------------
    # checkpoint/resume
    # ------------------------------------------------------------------
    def state_tree(self) -> dict:
        """The service's whole device state as one tree; under the
        hierarchical layout the log is drained into the host counts first
        (a watermark move: the run's math is untouched), which go too."""
        tree = {"state": self.state}
        if self._freq_host is not None:
            self._drain_log()
            tree["freq_host"] = self._freq_host
        return tree

    def _extra_state(self) -> dict:
        return {"aggs_done": int(self.aggs_done),
                "events_done": int(self.events_done),
                "cum_uplink": int(self.cum_uplink),
                "cum_downlink": int(self.cum_downlink),
                "log_seen": int(self._log_seen)}

    def save_state(self, checkpointer):
        """Snapshot the service into ``checkpointer`` (an
        ``AsyncCheckpointer``), keyed by the aggregation count."""
        tree = self.state_tree()     # first: its drain moves log_seen
        checkpointer.save(self.aggs_done, tree, extra=self._extra_state())

    def load_state(self, source, step: int | None = None):
        """Restore a :meth:`save_state` snapshot from ``source`` (an
        ``AsyncCheckpointer`` or a directory); the continued event stream
        is bitwise the uninterrupted one. The service must be built with
        the same config and seed. The state takes new buffers and the
        graphs are dropped."""
        path = getattr(source, "path", source)
        tree, meta = load_checkpoint(path, self.state_tree(), step=step)
        self._graphs.drop()
        self.state = C.map_rows(lambda t: t.to(self.device), tree["state"])
        if "freq_host" in tree:
            self._freq_host = np.array(tree["freq_host"])
        ex = meta["extra"]
        self.aggs_done = int(ex["aggs_done"])
        self.events_done = int(ex["events_done"])
        self.cum_uplink = int(ex["cum_uplink"])
        self.cum_downlink = int(ex["cum_downlink"])
        self._log_seen = int(ex["log_seen"])

    @torch.no_grad()
    def eval_acc(self) -> float:
        """Mean over clients of each client's accuracy on its own labels
        under the global params and its own model state."""
        t0 = time.perf_counter()
        tree = self._unflatten(self.state.g_params)
        accs = []
        for i, (xe, ye) in enumerate(self._eval_sets):
            with strict_fp32():
                logits = self._predict(tree, C.client_tree(
                    self.state.state_s, i), xe)
            accs.append((logits.argmax(-1) == ye).to(torch.float32).mean())
        acc = float(torch.stack(accs).mean())
        self.device_s += time.perf_counter() - t0
        return acc

    @property
    def cluster_of(self) -> np.ndarray:
        return self.state.age.cluster_of.cpu().numpy().astype(np.int64)

    @property
    def age(self) -> DeviceAgeState:
        return self.state.age

    @property
    def freq_matrix(self) -> np.ndarray:
        """The cumulative (N, d) request counts in either layout: the
        device's (dense) or the host's, the log drained first
        (hierarchical)."""
        if self.state.age.freq is not None:
            return self.state.age.freq.cpu().numpy()
        self._drain_log()
        return self._freq_host.copy()

    def _drain_log(self):
        """Fold the log slots written since the last drain into the
        host counts (hierarchical; else nothing)."""
        if self._freq_host is not None:
            self._log_seen = drain_request_log(
                self.state.age, self._freq_host, self._log_seen,
                n=self.n, d=self.d)

    def close(self):
        """Release the captured graphs. The service stays usable."""
        self._graphs.drop()

    def run_async(self, aggregations: int, *, eval_every: int = 5,
                  verbose: bool = False, checkpointer=None,
                  ckpt_every: int = 0) -> ServiceResult:
        """Drive the service until ``aggregations`` more flushes. Without
        faults every flush takes exactly K landings, so chunks run to the
        next host stop (recluster every M, eval, checkpoint, end); under
        faults a failed dispatch lands nothing, so the chunks are K
        events each and the flushes are counted (at most one a chunk).
        Chained calls continue the same event stream."""
        t0 = time.time()
        res = ServiceResult()
        end = self.aggs_done + aggregations
        faulty = self._faults is not None
        stall = 0
        while self.aggs_done < end:
            if faulty:
                # buf_count <= K-1 entering a chunk and a chunk lands at
                # most K updates: at most one flush, so the count never
                # overshoots a recluster or eval boundary
                metrics = self._advance(self.K)
                # failed landings write log slots too, so a recluster
                # window may hold more than its M K landings: the log is
                # drained every chunk
                self._drain_log()
                flushed_now = int(metrics["flushed"].sum())
                assert flushed_now <= 1
                self.aggs_done += flushed_now
                stall = 0 if flushed_now else stall + 1
                if stall >= STALL_CHUNKS:
                    raise RuntimeError(
                        f"async service stalled: no flush in the last "
                        f"{stall * self.K} events; the fault rate leaves "
                        f"fewer than K={self.K} live clients")
            else:
                stop = self._next_stop(end, eval_every, ckpt_every)
                n_aggs = stop - self.aggs_done
                metrics = self._advance(n_aggs * self.K)
                assert int(metrics["flushed"].sum()) == n_aggs
                flushed_now = n_aggs
                self.aggs_done = stop
            a = self.aggs_done
            res.clients.extend(int(c) for c in metrics["client"])
            res.staleness.extend(int(s) for s in metrics["staleness"])
            res.event_clock.extend(float(c) for c in metrics["clock"])
            res.requested.extend(metrics["idx"])
            n_ev = len(metrics["client"])
            n_up = n_ev
            if faulty:
                for key in ("quarantined", "crashed", "dropped", "retried"):
                    getattr(res, key).extend(bool(q) for q in metrics[key])
                # crashed clients put nothing on the wire; dropped and
                # quarantined uploads were sent and paid for
                n_up -= int(metrics["crashed"].sum())
            self.cum_uplink += self._uplink_per_landing * n_up
            # every landing triggers exactly one re-dispatch
            self.cum_downlink += self._downlink_per_dispatch * n_ev
            if flushed_now and a % self.hp.M == 0:
                self._recluster()
            if (checkpointer is not None and ckpt_every and flushed_now
                    and a % ckpt_every == 0):
                self.save_state(checkpointer)
            if flushed_now and (a % eval_every == 0 or a == end):
                acc = self.eval_acc()
                # the last flush window's K landings (the engine's round
                # loss, degenerately); crashed dispatches log NaN
                win = metrics["loss"][-self.K:]
                loss = (float(np.nanmean(win)) if np.isfinite(win).any()
                        else float("nan"))
                res.rounds.append(a)
                res.loss.append(loss)
                res.acc.append(acc)
                res.uplink_bytes.append(self.cum_uplink)
                res.downlink_bytes.append(self.cum_downlink)
                res.clock.append(float(metrics["clock"][-1]))
                res.cluster_labels.append(self.cluster_of)
                if verbose:
                    print(f"[async k={self.K} eta={self.eta} V={self.V}] "
                          f"agg {a:4d} t={res.clock[-1]:8.2f}s "
                          f"loss={loss:.4f} acc={acc:.4f} "
                          f"stale_max={max(res.staleness):d}")
        res.wall_s = time.time() - t0
        return res
