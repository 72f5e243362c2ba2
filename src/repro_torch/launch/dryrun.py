"""The dry run: every (architecture x input shape x production mesh)
step traced on fake tensors, with its per-device roofline terms: the
port of ``repro.launch.dryrun``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table [--out DIR] [--ref REF_DIR]

The reference compiles each step for 512 forced host devices and reads
XLA's cost analysis and the HLO's collectives. The port has no compiled
module to read: it runs the step from ``launch.steps.lower_combo`` on
``DTensor``s whose local shards are fake tensors (``FakeTensorMode``),
over the fake process group of ``launch.mesh.make_production_mesh``
(256 or 512 ranks, this process rank 0). Nothing is allocated and
nothing is launched on any device: this entry point, alone of the
port's, needs no card. Tensors that the model makes inside the step
(positions, RoPE tables, masks) enter under ``implicit_replication``.
It reads, per device:

* FLOPs: ``torch.utils.flop_counter``'s formulas on each op's LOCAL
  shards (:class:`_Counter`; a ``FlopCounterMode`` above DTensor counts
  the global op instead);
* bytes: each op's local input and output bytes, an upper bound, since
  nothing is fused;
* collective bytes: the output bytes of each collective that reaches the
  fake group (DTensor's functional collectives and the manual sync's
  ``dist.all_gather``), by the reference's five kinds; a shard-dim
  reshard is an all-to-all of the local shard, as on the H100 mesh
  (:func:`alltoall_reshards`);
* memory: the local bytes of the arguments and of the outputs, and the
  peak of ``torch.distributed._tools.mem_tracker.MemTracker`` over the
  local ops (:func:`_tracker_class`); "temp" is the peak less the
  arguments; and the tensors live at the peak, each with the op and the
  model line that made it (noting them costs less than a trace's spread
  from run to run).

The cost totals come from 1- and 2-unit probes extrapolated to the full
depth, as the reference's (:func:`probe_roofline`); the memory from the
full-depth step. The roofline terms use the H100 constants of
``launch.mesh``. Records go to ``build/dryrun/`` (``--out``), one JSON a
combination.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from contextlib import contextmanager

import torch
import torch.distributed as dist

from repro_torch import tree as _tree
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.dist import regions as RG
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.launch.steps import lower_combo

# combinations that do not exist architecturally
SKIPS = {
    ("whisper-large-v3", "long_500k"): "audio encoder capped at 1500 frames;"
                                       " 500k-frame context does not exist",
}

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun")

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# collective op name -> the reference's kind
_COLL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

_FREE = {"empty", "empty_strided", "empty_like", "detach", "device",
         "wait_tensor", "lift_fresh", "alias", "_local_scalar_dense"}


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tree.leaves(x)
               if isinstance(t, torch.Tensor))


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is running the op on global
    shapes (to learn its output's metadata), not on the local shards."""
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        if ("propagat" in code.co_name
                and "distributed" in code.co_filename):
            return True
        f = f.f_back
    return False


@contextmanager
def _no_modes():
    yield


def _counter_class():
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Counter(TorchDispatchMode):
        """FLOPs, bytes and collective bytes of the ops on local shards:
        an op on DTensors is handed on to DTensor (NotImplemented), whose
        local ops come back here."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.coll = {k: 0 for k in KINDS}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            name = func._overloadpacket.__name__
            if name in _FREE or _in_propagation():
                return out
            kind = _COLL.get(name)
            if kind is not None:
                self.coll[kind] += _nbytes(out) or _nbytes(args[0])
                return out
            ret = func._schema.returns
            if ret and ret[0].alias_info is not None \
                    and not ret[0].alias_info.is_write:
                return out                       # a view moves nothing
            pk = func._overloadpacket
            if pk in flop_registry:
                self.flops += flop_registry[pk](*args, **kwargs,
                                                out_val=out)
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            return out

    return _Counter


_SRC = os.path.join(os.path.dirname(__file__), "..", "..")


def _model_line() -> str:
    """file:line of the innermost frame in the port's model code; "?"
    where none is on the stack (the backward, which autograd's engine
    runs)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and "models" in fn:
            return f"{os.path.relpath(fn, _SRC)}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _tracker_class():
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class _LocalMemTracker(MemTracker):
        """``MemTracker`` over the local shards alone: DTensor ops are handed
        on, and the global-shape temporaries of DTensor's sharding
        propagation are not tracked (above DTensor it counts a view of a
        sharded tensor at its global size). It also notes each storage's
        first and last op, with the op, the model line, the shape and the
        dtype that made it, for :meth:`live_at_peak`."""

        def __init__(self):
            super().__init__()
            self._rows = []
            self._op = 0
            self._peak = (-1, "", 0)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if _in_propagation():
                return func(*args, **(kwargs or {}))
            out = super().__torch_dispatch__(func, types, args, kwargs)
            self._note(func._overloadpacket.__name__, out)
            return out

        def _note(self, name, out):
            self._op += 1
            at = None
            for t in _tree.leaves(out):
                if not isinstance(t, torch.Tensor):
                    continue
                winfo = self._WINFO.get(t.untyped_storage(), (None,))[0]
                if winfo is not None and not hasattr(winfo, "row"):
                    at = at or _model_line()
                    winfo.row = [winfo.mem_consumed, name, at,
                                 tuple(t.shape), str(t.dtype), self._op, None]
                    self._rows.append(winfo.row)
            total = sum(v["Total"] for v in self._curr_mem_snap.values())
            if total > self._peak[0]:
                self._peak = (total, f"{name} at {at or _model_line()}",
                              self._op)

        def _delete_callback(self, winfo, w_st):
            row = getattr(winfo, "row", None)
            if row is not None:
                row[-1] = self._op
            super()._delete_callback(winfo, w_st)

        def live_at_peak(self, top: int = 12) -> dict:
            """The peak's bytes, the op that reached it, and the ``top``
            largest storages that the step made and that were live there,
            as [bytes, op, model line, shape, dtype] (the arguments, which
            the record counts apart, are not among them)."""
            total, op, at = self._peak
            live = sorted((r for r in self._rows if r[5] <= at
                           and (r[6] is None or r[6] >= at)),
                          key=lambda r: -r[0])
            return {"bytes": total, "op": op,
                    "live": [r[:5] for r in live[:top]]}

    return _LocalMemTracker


@contextmanager
def alltoall_reshards():
    """For the extent, DTensor's shard-dim reshards (``Shard(i)`` to
    ``Shard(j)`` on one mesh dim) run as the H100 mesh runs them: the
    ``_dtensor.shard_dim_alltoall`` op of the local shard over the mesh
    dim's group, which the counter books as all-to-all. On a mesh whose
    device type is ``cpu`` (the fake group's) DTensor would all-gather
    the full width and chunk it, which gloo needs but NCCL does not.
    Raises where this torch lacks the names it replaces; never falls
    back to the gather."""
    from torch.distributed.tensor import _collective_utils as CU
    from torch.distributed.tensor import placement_types as PT

    if not (hasattr(PT, "shard_dim_alltoall")
            and hasattr(CU, "shard_dim_alltoall")
            and hasattr(torch.ops._dtensor, "shard_dim_alltoall")):
        raise RuntimeError(
            f"dryrun: torch {torch.__version__} has no DTensor "
            "shard_dim_alltoall to route shard-dim reshards through")

    def alltoall(local, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            local, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    saved = PT.shard_dim_alltoall, CU.shard_dim_alltoall
    PT.shard_dim_alltoall = CU.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        PT.shard_dim_alltoall, CU.shard_dim_alltoall = saved


def reshard_check() -> dict:
    """:func:`trace` of one shard-dim reshard, ``Shard(1)`` to ``Shard(2)``
    on the model axis of a fake (2, 4) mesh; raises unless this torch's
    DTensor books it as the all-to-all of the local shard, with no
    all-gather and nothing larger than the local shard live at the peak.
    Its record."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from repro_torch.dist import sharding as SH
    from repro_torch.launch.steps import Lowered

    with fake_group(8):
        mesh = SH.from_device_mesh(init_device_mesh(
            "cpu", (2, 4), mesh_dim_names=("data", "model")))
        dm = mesh.device_mesh
        x = torch.empty((4, 64, 32, 8), dtype=torch.bfloat16, device="meta")
        rec = trace(Lowered(
            lambda t: t.redistribute(dm, [Shard(0), Shard(2)]), (x,),
            (SH.placements(mesh, SH.P("data", "model")),), mesh, "reshard"))
    local = x.numel() * x.element_size() // 8
    live = rec["memory"]["peak"]["live"]
    if (rec["coll"]["all-to-all"] != local or rec["coll"]["all-gather"]
            or max(row[0] for row in live) != local):
        raise RuntimeError(f"dryrun: torch {torch.__version__} did not "
                           f"book a shard-dim reshard as all-to-all: {rec}")
    return rec


@contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for
    the extent; destroyed after. Refuses to replace an initialized
    group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _dtensors(args, placements, mesh):
    """The step's arguments as DTensors of fake local shards: each
    ``meta`` leaf at its global shape, cut under its placements."""
    from torch.distributed.tensor import DTensor, Shard

    dm = mesh.device_mesh

    def one(t, pl):
        if not isinstance(t, torch.Tensor):
            return t
        local = list(t.shape)
        for md, p in enumerate(pl):
            if isinstance(p, Shard):
                local[p.dim] //= dm.shape[md]
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype), dm, pl, run_check=False,
            shape=t.shape, stride=torch.empty(t.shape, device="meta").stride())

    out = []
    for a, pl in zip(args, placements):
        if pl is None:
            out.append(a)
        else:
            out.append(_tree.tree_map(one, a, pl))
    return tuple(out)


def _local_bytes(x) -> int:
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in _tree.leaves(x)
               if isinstance(t, torch.Tensor))


def trace(lowered, *, memory: bool = True) -> dict:
    """Run ``lowered`` (``launch.steps.Lowered``) once on fake DTensors:
    {"flops", "bytes", "coll" {kind: bytes}} per device, and with
    ``memory`` the memory record, whose "peak" entry lists what is live
    at the tracker's peak."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    counter = _counter_class()()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = _dtensors(lowered.args, lowered.placements, lowered.mesh)
        arg_bytes = _local_bytes(args)
        tracker = None
        if memory:
            tracker = _tracker_class()()
            tracker.track_external(*[t for t in _tree.leaves(args)
                                     if isinstance(t, torch.Tensor)])
        with counter, (tracker if tracker is not None else _no_modes()), \
                implicit_replication(), RG.matmul_mode(), \
                alltoall_reshards():
            out = lowered.fn(*args)
        rec = {"flops": float(counter.flops), "bytes": float(counter.bytes),
               "coll": {k: float(v) for k, v in counter.coll.items()}}
        if tracker is not None:
            out_bytes = _local_bytes(out)
            alias = sum(_local_bytes(args[i]) for i in lowered.donate)
            top = max(tracker.get_tracker_snapshot("peak").get(
                dev, {}).get("Total", 0) for dev in
                tracker.get_tracker_snapshot("peak")) if \
                tracker.get_tracker_snapshot("peak") else 0
            temp = max(0, top - arg_bytes)
            rec["memory"] = {
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": temp,
                "alias_bytes": alias,
                "peak_bytes": top,
                "per_device_total": arg_bytes + temp + out_bytes - alias,
                "peak": tracker.live_at_peak(),
            }
    return rec


def host_mesh_trace(cfg, shape, data: int, model: int, *,
                    sync: str = "auto", memory: bool = False) -> dict:
    """:func:`trace` of one step on a (data, model) mesh over a fake group
    of data x model ranks (the smoke tests' meshes)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import sharding as SH

    with fake_group(data * model):
        mesh = SH.from_device_mesh(init_device_mesh(
            "cpu", (data, model), mesh_dim_names=("data", "model")))
        lowered, kind = lower_combo(cfg, shape, mesh, sync=sync)
        return dict(trace(lowered, memory=memory), kind=kind)


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    return {
        "compute_s": flops_per_dev / PEAK_FLOPS_BF16,
        "memory_s": bytes_per_dev / HBM_BW,
        "collective_s": coll_bytes_per_dev / NVLINK_BW,
    }


def probe_roofline(cfg, shape, mesh, sync: str = "auto") -> dict:
    """Per-device cost totals by layer-count extrapolation, as the
    reference's: 1- and 2-unit probes (unit = attn_every for hybrids, 1
    layer otherwise; encoder and decoder together for enc-dec), then
        total = p1 + (n_units - 1) * (p2 - p1),
    each term floored at its 2-unit probe (collectives at 0). Probes run
    the full global batch with grad-accum off."""
    u = cfg.attn_every if cfg.family == "hybrid" else 1
    n_units = cfg.n_layers // u

    def probe_cfg(units):
        kw = dict(n_layers=u * units, grad_accum={}, remat=cfg.remat)
        if cfg.is_encoder_decoder:
            kw["encoder_layers"] = units
        return cfg.replace(**kw)

    p = []
    for units in (1, 2):
        lowered, _ = lower_combo(probe_cfg(units), shape, mesh, sync=sync)
        p.append(trace(lowered, memory=False))
    p1, p2 = p
    out = {"flops": p1["flops"] + (n_units - 1) * (p2["flops"] - p1["flops"]),
           "bytes": p1["bytes"] + (n_units - 1) * (p2["bytes"] - p1["bytes"]),
           "coll": {k: p1["coll"][k] + (n_units - 1)
                    * (p2["coll"][k] - p1["coll"][k]) for k in p1["coll"]}}
    out["flops"] = max(out["flops"], p2["flops"])
    out["bytes"] = max(out["bytes"], p2["bytes"])
    out["coll"] = {k: max(v, 0.0) for k, v in out["coll"].items()}
    return out


def run_combo(arch: str, shape_name: str, *, multi_pod: bool,
              out_dir: str | None = None, verbose: bool = True,
              sync: str = "auto", tag: str = "", cfg=None) -> dict:
    """One combination's record (the reference's keys), traced at the
    production mesh over a fake group, written to ``out_dir`` (a skipped
    combination's too, where the reference writes none)."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "ok", "sync": sync}
    if (arch, shape_name) in SKIPS:
        rec["status"] = "skip"
        rec["reason"] = SKIPS[(arch, shape_name)]
    else:
        _run(rec, get_config(arch), INPUT_SHAPES[shape_name], multi_pod,
             verbose)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fn = os.path.join(out_dir,
                          f"{arch}_{shape_name}_{mesh_name}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _run(rec, cfg, shape, multi_pod, verbose):
    arch, shape_name, mesh_name, sync = (rec["arch"], rec["shape"],
                                         rec["mesh"], rec["sync"])
    t0 = time.time()
    n_chips = 512 if multi_pod else 256
    try:
        with fake_group(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod)
            rec.update(_measure(cfg, shape, mesh, sync, t0))
        if verbose:
            terms = rec["roofline"]
            print(f"[OK] {arch} x {shape_name} x {mesh_name} ({rec['kind']}) "
                  f"trace={rec['lower_s']:.0f}s dom={rec['dominant']} "
                  f"terms=({terms['compute_s']:.2e},{terms['memory_s']:.2e},"
                  f"{terms['collective_s']:.2e})s "
                  f"mem/dev={rec['memory']['per_device_total']/2**30:.2f}GiB",
                  flush=True)
            pk = rec["memory"]["peak"]
            print(f"  peak {pk['bytes']:,} B after {pk['op']}; live:")
            for row in pk["live"]:
                print(f"    {row[0]:>14,} B {row[1]} at {row[2]} "
                      f"{tuple(row[3])} {row[4]}")
    except Exception as e:  # noqa: BLE001 - record failures, keep sweeping
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_name}: "
                  f"{rec['error'][:300]}", flush=True)


def _measure(cfg, shape, mesh, sync, t0) -> dict:
    n_chips = math.prod(mesh.shape.values())
    lowered, kind = lower_combo(cfg, shape, mesh, sync=sync)
    full = trace(lowered)
    t_trace = time.time() - t0
    pm = probe_roofline(cfg, shape, mesh, sync=sync)
    coll = pm["coll"]
    coll_total = float(sum(coll.values()))
    terms = roofline_terms(pm["flops"], pm["bytes"], coll_total)
    dom = max(terms, key=terms.get)
    n_model = cfg.param_count()
    n_active = cfg.param_count(active_only=True)
    tokens = shape.global_batch * (shape.seq_len if kind == "train" else 1)
    if kind == "train":
        model_flops = 6 * n_active * tokens
    elif kind == "prefill":
        model_flops = 2 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * n_active * shape.global_batch
    return {
        "kind": kind,
        "n_chips": n_chips,
        "lower_s": round(t_trace, 1),
        "compile_s": round(time.time() - t0 - t_trace, 1),
        "flops_per_dev": pm["flops"],
        "bytes_per_dev": pm["bytes"],
        "collective_bytes_per_dev": coll,
        "collective_total_per_dev": coll_total,
        "roofline": terms,
        "dominant": dom,
        "params": n_model,
        "params_active": n_active,
        "model_flops_total": model_flops,
        "useful_flops_ratio": (model_flops / (pm["flops"] * n_chips)
                               if pm["flops"] else 0.0),
        "memory": full["memory"],
    }


def _records(out_dir: str) -> dict:
    recs = {}
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                r = json.load(f)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def table(out_dir: str, ref_dir: str | None = None) -> str:
    """The records under ``out_dir`` as one markdown row an arch and a
    column a shape: for each mesh (16x16, then 2x16x16) the dominant term,
    the compute, memory and collective terms in seconds and the memory a
    device in GiB, or why the combination failed or was skipped (the
    table of PERF.md). With ``ref_dir`` (the records of ``python -m
    repro.launch.dryrun --out DIR``) the reference's memory a device
    stands beside the port's, and a second table gives both sides'
    collective bytes a device by kind."""
    recs = _records(out_dir)
    refs = _records(ref_dir) if ref_dir else {}

    def cell(r):
        if r is None:
            return "not run"
        if r["status"] == "skip":
            return "skip"
        if r["status"] == "fail":
            return "fail: " + r["error"].split(":")[0]
        t = r["roofline"]
        ref = refs.get((r["arch"], r["shape"], r["mesh"]))
        beside = ""
        if ref_dir:
            beside = (f" (ref {ref['memory']['per_device_total'] / 2**30:.1f})"
                      if ref and ref["status"] == "ok" else " (ref none)")
        return (f"{r['dominant'][:3]} {t['compute_s']:.3g} / "
                f"{t['memory_s']:.3g} / {t['collective_s']:.3g}, "
                f"{r['memory']['per_device_total'] / 2**30:.1f}{beside}")

    def coll(r):
        if r is None or r["status"] != "ok":
            return cell(r)
        ref = refs.get((r["arch"], r["shape"], r["mesh"]))
        out = []
        for kind in KINDS:
            v = f"{r['collective_bytes_per_dev'][kind] / 1e9:.3g}"
            if ref and ref["status"] == "ok":
                v += f"/{ref['collective_bytes_per_dev'][kind] / 1e9:.3g}"
            out.append(f"{_ABBR[kind]} {v}")
        return " ".join(out)

    def grid(fn):
        rows = ["| Arch | " + " | ".join(INPUT_SHAPES) + " |",
                "|---" * (len(INPUT_SHAPES) + 1) + "|"]
        for arch in ASSIGNED_ARCHS:
            rows.append(f"| {arch} | " + " | ".join(
                "; ".join(fn(recs.get((arch, shape, m)))
                          for m in ("16x16", "2x16x16"))
                for shape in INPUT_SHAPES) + " |")
        return rows

    rows = grid(cell)
    if ref_dir:
        rows += ["", "Collective GB a device by kind, the port's / the "
                 "reference's (16x16; 2x16x16):", ""] + grid(coll)
    return "\n".join(rows)


_ABBR = {"all-reduce": "ar", "all-gather": "ag", "reduce-scatter": "rs",
         "all-to-all": "a2a", "collective-permute": "cp"}


def main(argv=None):
    import logging

    logging.getLogger("torch").setLevel(logging.ERROR)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED_ARCHS + ["all"], default="all")
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (as --arch all --shape all)")
    ap.add_argument("--shape", choices=list(INPUT_SHAPES) + ["all"],
                    default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sync", choices=("auto", "dense", "rage_k"),
                    default="auto")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=os.path.normpath(OUT_DIR))
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out as a table")
    ap.add_argument("--ref", default=None,
                    help="with --table: the reference's records, whose "
                         "memory a device and collectives by kind stand "
                         "beside the port's")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out, args.ref))
        return 0

    rec = reshard_check()
    print(f"reshard check: a shard-dim reshard of {rec['coll']['all-to-all']:.0f}"
          f" B booked as all-to-all under torch {torch.__version__}",
          flush=True)
    archs = ASSIGNED_ARCHS if args.all or args.arch == "all" else [args.arch]
    shapes = (list(INPUT_SHAPES) if args.all or args.shape == "all"
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_combo(arch, shape, multi_pod=mp, out_dir=args.out,
                                sync=args.sync, tag=args.tag)
                n_fail += rec["status"] == "fail"
    print(f"\ndone; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
