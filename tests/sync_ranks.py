"""Two data shards of the manual sparse sync, for
``tests/test_torch_sparse_sync.py``: each scenario's two calls on the
port over two gloo ranks on the CPU, or on the reference over a
2-device CPU mesh (run with ``XLA_FLAGS=--xla_force_host_platform_device
_count=2``).

  python tests/sync_ranks.py torch IN.npz OUT_DIR
  python tests/sync_ranks.py jax IN.npz OUT_DIR

IN holds the gradient leaves of each rank (``g{rank}_{leaf:02d}``),
``r`` and ``k``. A gradient tree is {"l00": leaf 0, "l01": ...}, whose
sorted keys give both packages the leaves' order. The torch mode writes
``torch_rank{q}.npz`` for each rank, the jax mode ``jax.npz``: for every
scenario and call the synced leaves, the age leaves and the stats.
"""
import os
import sys

import numpy as np

# (name, method, candidates, validate, active of the two calls, buffer_k,
#  distinct): identical gradients on both ranks unless distinct
SCENARIOS = [
    ("rage_k_threshold", "rage_k", "threshold", False, (None, None), 0,
     False),
    ("rage_k_masked", "rage_k", "sort", False,
     ((True, False), (False, True)), 0, False),
    ("cafe", "cafe", "sort", False, (None, None), 0, False),
    ("top_k_masked", "top_k", "sort", False, ((False, True), None), 0,
     False),
    ("dense", "dense", "sort", False, (None, (True, False)), 0, False),
    ("rage_k_gate", "rage_k", "sort", True, (None, None), 0, False),
    ("buffered", "rage_k", "sort", False, (None, None), 3, False),
    # distinct gradients: rank 1's are rank 0's reversed and scaled, and
    # under the gate rank 1's second call is out of band
    ("distinct_rage_k", "rage_k", "sort", False, (None, None), 0, True),
    ("distinct_top_k", "top_k", "sort", False, (None, (True, True)), 0,
     True),
    ("distinct_dense", "dense", "sort", False, (None, (False, True)), 0,
     True),
    ("distinct_gate", "rage_k", "threshold", True, (None, None), 0, True),
]


def load(path):
    data = np.load(path)
    n = max(int(k.split("_")[1]) for k in data.files if k.startswith("g0_"))
    grads = [{f"l{i:02d}": data[f"g{q}_{i:02d}"] for i in range(n + 1)}
             for q in (0, 1)]
    return grads, int(data["r"]), int(data["k"])


def rank_grads(grads, q, distinct, call, validate):
    """Rank q's gradient leaves for one call of a scenario."""
    g = grads[q] if distinct else grads[0]
    if distinct and validate and q == 1 and call == 1:
        g = {k: v * np.float32(1e9) for k, v in g.items()}
    return g


def _flat_out(out, name, call, synced, ages, stats):
    for k in sorted(synced):
        out[f"{name}/{call}/synced/{k}"] = np.asarray(synced[k], np.float32)
        out[f"{name}/{call}/ages/{k}"] = np.asarray(ages[k])
    for k, v in stats.items():
        out[f"{name}/{call}/stats/{k}"] = np.asarray(v).astype(np.float64)


def run_torch_rank(rank, path_in, out_dir, init_file):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sparse_sync as SS
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=2)
    grads, r, k = load(path_in)
    mesh = make_host_mesh(2, 1, device="cpu")
    shapes = {n: torch.empty(v.shape, device="meta")
              for n, v in grads[0].items()}
    out = {}
    for name, method, cand, validate, actives, bk, distinct in SCENARIOS:
        kw = dict(method=method, candidates=cand, r=r, k=k,
                  validate=validate)
        if bk:
            sync = SS.make_buffered_sync(mesh, None, shapes, buffer_k=bk,
                                         **kw)
            buf = sync.init_buffer()
        else:
            sync = SS.make_manual_sync(mesh, None, shapes, **kw)
        ages = SS.init_age_state_sharded(shapes, method=method,
                                         device="cpu")
        for call, act in enumerate(actives):
            g = {n: torch.from_numpy(v.copy()) for n, v in
                 rank_grads(grads, rank, distinct, call, validate).items()}
            act = None if act is None else torch.tensor(act)
            if bk:
                synced, ages, buf, stats = sync(g, ages, buf, active=act)
            else:
                synced, ages, stats = sync(g, ages, active=act)
            _flat_out(out, name, call, {n: t.numpy() for n, t in
                                        synced.items()},
                      {n: t.numpy() for n, t in ages.items()},
                      {n: (v if isinstance(v, int) else v.numpy())
                       for n, v in stats.items()})
    np.savez(os.path.join(out_dir, f"torch_rank{rank}.npz"), **out)
    dist.destroy_process_group()


def run_jax(path_in, out_dir):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.dist.sparse_sync import (init_age_state_sharded,
                                        make_buffered_sync,
                                        make_manual_sync)
    from repro.launch.mesh import make_host_mesh

    grads, r, k = load(path_in)
    mesh = make_host_mesh(2, 1)
    assert mesh.shape["data"] == 2, mesh.shape
    specs = {n: P() for n in grads[0]}
    shapes = {n: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for n, v in grads[0].items()}
    out = {}
    for name, method, cand, validate, actives, bk, distinct in SCENARIOS:
        if distinct:
            continue
        kw = dict(method=method, candidates=cand, r=r, k=k,
                  validate=validate)
        if bk:
            base = make_buffered_sync(mesh, specs, shapes, buffer_k=bk,
                                      **kw)
            buf = base.init_buffer()
        else:
            base = make_manual_sync(mesh, specs, shapes, **kw)
        sync = jax.jit(base)
        ages = init_age_state_sharded(shapes, method=method)
        for call, act in enumerate(actives):
            g = {n: jnp.asarray(v) for n, v in grads[0].items()}
            act = None if act is None else jnp.asarray(act)
            if bk:
                synced, ages, buf, stats = sync(g, ages, buf, active=act)
            else:
                synced, ages, stats = sync(g, ages, active=act)
            _flat_out(out, name, call, synced, ages, stats)
    np.savez(os.path.join(out_dir, "jax.npz"), **out)


if __name__ == "__main__":
    mode, path_in, out_dir = sys.argv[1:4]
    if mode == "jax":
        run_jax(path_in, out_dir)
    else:
        import torch.multiprocessing as mp
        init_file = os.path.join(out_dir, "pg_init")
        mp.spawn(run_torch_rank, args=(path_in, out_dir, init_file),
                 nprocs=2)
