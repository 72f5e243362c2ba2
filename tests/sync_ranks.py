"""Two data shards of the manual sparse sync, for
``tests/test_torch_sparse_sync.py``: each scenario's two calls on the
port over two gloo ranks on the CPU, or on the reference over a
2-device CPU mesh (run with ``XLA_FLAGS=--xla_force_host_platform_device
_count=2``). And a (data 2, model 2) mesh of the model-sharded sync, for
``tests/test_torch_sharding.py``: the port on four gloo ranks, each
passing its local slices, or the reference on four forced host devices
(the ``torch4`` and ``jax4`` modes, :func:`start4`, :func:`collect4`,
:func:`check_four_ranks_match_reference`). The ``torch4`` ranks also
run ``regions.merge_heads`` on that mesh (:func:`run_merge_heads`,
:func:`check_merge_heads`).

  python tests/sync_ranks.py torch IN.npz OUT_DIR
  python tests/sync_ranks.py jax IN.npz OUT_DIR
  python tests/sync_ranks.py torch4 IN.npz OUT_DIR
  python tests/sync_ranks.py jax4 IN.npz OUT_DIR

IN holds the gradient leaves of each rank (``g{rank}_{leaf:02d}``),
``r`` and ``k``. A gradient tree is {"l00": leaf 0, "l01": ...}, whose
sorted keys give both packages the leaves' order. The torch mode writes
``torch_rank{q}.npz`` for each rank, the jax mode ``jax.npz``: for every
scenario and call the synced leaves, the age leaves and the stats.

A test module starts both with :func:`start` from its gradient leaves,
gathers them with :func:`collect`, and holds them to each other, to the
reference and to the numpy oracle of the union semantics with
:func:`check_ranks_agree`, :func:`check_identical_match_reference` and
:func:`check_distinct_match_oracle`.
"""
import os
import subprocess
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
    """Rank q's gradient leaves for one call of a scenario: distinct,
    rank 1's are rank 0's reversed and scaled and from rank 2 on rank 0's
    scaled by 1 + 0.3 q (the same picks, so three or more uploads land on
    one coordinate)."""
    if distinct and q >= 2:
        return {k: v * np.float32(1 + 0.3 * q) for k, v in grads[0].items()}
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


def _actives(act, n: int):
    """A scenario's two-rank activity mask cycled over ``n`` ranks."""
    return None if act is None else tuple(act[q % 2] for q in range(n))


def _out_name(kind: str, n: int, rank: int = 0) -> str:
    if kind == "torch":
        return (f"torch_rank{rank}.npz" if n == 2
                else f"torch_{n}ranks_rank{rank}.npz")
    return "jax.npz" if n == 2 else f"jax_{n}ranks.npz"


def run_torch_rank(rank, path_in, out_dir, init_file, world=2):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sparse_sync as SS
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    grads, r, k = load(path_in)
    mesh = make_host_mesh(world, 1, device="cpu")
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
            act = _actives(act, world)
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
    np.savez(os.path.join(out_dir, _out_name("torch", world, rank)), **out)
    dist.destroy_process_group()


def run_jax(path_in, out_dir, n=2):
    """The reference on ``n`` forced host devices (a (n, 1) mesh). At two
    devices the identical scenarios alone; from three on every scenario,
    each device's gradients its rank's (:func:`rank_grads`): a replicated
    array whose device buffers differ, which the sync's ``shard_map``
    reads as each data shard's own gradient."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.dist.sparse_sync import (init_age_state_sharded,
                                        make_buffered_sync,
                                        make_manual_sync)
    from repro.launch.mesh import make_host_mesh

    from jax.sharding import NamedSharding

    grads, r, k = load(path_in)
    n_data = n
    mesh = make_host_mesh(n_data, 1)
    assert mesh.shape["data"] == n_data, mesh.shape
    specs = {n: P() for n in grads[0]}
    shapes = {n: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for n, v in grads[0].items()}
    devices = list(mesh.devices[:, 0])

    def per_device(arrays):
        return jax.make_array_from_single_device_arrays(
            arrays[0].shape, NamedSharding(mesh, P()),
            [jax.device_put(a, dv) for a, dv in zip(arrays, devices)])

    out = {}
    for name, method, cand, validate, actives, bk, distinct in SCENARIOS:
        if distinct and n_data == 2:
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
            per = [rank_grads(grads, q, distinct, call, validate)
                   for q in range(n_data)]
            g = {name_: per_device([p[name_] for p in per])
                 for name_ in grads[0]}
            act = _actives(act, n_data)
            act = None if act is None else jnp.asarray(act)
            if bk:
                synced, ages, buf, stats = sync(g, ages, buf, active=act)
            else:
                synced, ages, stats = sync(g, ages, active=act)
            _flat_out(out, name, call, synced, ages, stats)
    np.savez(os.path.join(out_dir, _out_name("jax", n_data)), **out)


def start(leaves, d, r: int, k: int, worlds=(2,)) -> list:
    """Both modes in the background on ``leaves`` (rank 0's gradient
    leaves, float32 numpy arrays; rank 1's are rank 0's reversed and
    scaled by 0.7, the distinct scenarios), for each world size in
    ``worlds`` (one spawn of its gloo ranks, one reference on as many
    devices), writing into the directory ``d`` (a ``pathlib.Path``).
    Returns the processes, two a world size."""
    here = os.path.dirname(os.path.abspath(__file__))
    g1 = [(np.ascontiguousarray(l.reshape(-1)[::-1]) * np.float32(0.7))
          .reshape(l.shape) for l in leaves]
    arrays = {f"g{q}_{i:02d}": l for q, gs in enumerate((leaves, g1))
              for i, l in enumerate(gs)}
    np.savez(d / "in.npz", r=r, k=k, **arrays)
    env = {**os.environ, "PYTHONPATH": os.path.join(here, "..", "src"),
           "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, os.path.join(here, "sync_ranks.py"), mode,
         str(d / "in.npz"), str(d), str(n)], env=dict(env, **extra),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for n in worlds for mode, extra in (
            ("torch", {}),
            ("jax", {"XLA_FLAGS": "--xla_force_host_platform_device_count="
                                  f"{n}", "JAX_PLATFORMS": "cpu"}))]


def collect(d, procs, n: int = 2) -> dict:
    """Wait for :func:`start`'s processes of world size ``n``; their
    outputs, the gradients, r and k."""
    for p in procs:
        if p.args[-1] != str(n):
            continue
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    grads, r, k = load(d / "in.npz")
    return dict(torch=[dict(np.load(d / _out_name("torch", n, q)))
                       for q in range(n)],
                jax=dict(np.load(d / _out_name("jax", n))), grads=grads,
                r=r, k=k)


def check_ranks_agree(runs):
    """Every rank holds rank 0's synced values, ages and stats."""
    a = runs["torch"][0]
    for b in runs["torch"][1:]:
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def check_identical_match_reference(runs):
    """Identical gradients: rank 0 == the reference's 2-device mesh, every
    scenario, both calls, exactly."""
    got, want = runs["torch"][0], runs["jax"]
    assert want and set(want) <= set(got)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# the reference's synced values against the port's from three data ranks
# on, where they may differ: within this, relative to each value
RANKS_RTOL = 1e-6


def exact_at(scen, call, n: int) -> bool:
    """Whether the reference's synced values of ``scen``'s call ``call``
    at ``n`` data ranks are the port's bitwise. Its union scatter sums
    the uploads in rank order, as ``sparse_aggregate`` does; but without
    a mask or the gate it divides by the static shard count, which XLA
    turns into a product with its reciprocal (exact at 2 and 4 ranks, not
    at 3), and its dense mean sums in its all-reduce's order, not gloo's."""
    _name, method, _cand, validate, actives, _bk, _distinct = scen
    if method == "dense":
        return n == 2
    return (n & (n - 1)) == 0 or validate or actives[call] is not None


def check_ranks_match_reference(runs, n: int):
    """Rank 0 == the reference on ``n`` devices, every scenario (distinct
    gradients too), both calls: ages and stats exactly, synced values
    exactly where :func:`exact_at` says so, else within ``RANKS_RTOL``
    with the same support."""
    got, want = runs["torch"][0], runs["jax"]
    n_exact = 0
    for scen in SCENARIOS:
        for call in range(len(scen[4])):
            pre = f"{scen[0]}/{call}/"
            keys = [k for k in want if k.startswith(pre)]
            assert keys, pre
            exact = exact_at(scen, call, n)
            n_exact += exact
            for key in keys:
                if "/synced/" in key and not exact:
                    np.testing.assert_array_equal(got[key] != 0,
                                                  want[key] != 0, key)
                    np.testing.assert_allclose(got[key], want[key],
                                               rtol=RANKS_RTOL, atol=0,
                                               err_msg=key)
                else:
                    np.testing.assert_array_equal(got[key], want[key],
                                                  err_msg=key)
    return n_exact


def _bf16(x):
    import ml_dtypes
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def _oracle_pick(g, age, method, r, k):
    """One rank's picks in numpy: top-r by |g| (stable, ties to the lower
    index), then the k oldest of them (stable, ties to the larger
    magnitude); top_k the k largest |g|."""
    order = np.argsort(-np.abs(g), kind="stable")
    if method == "top_k":
        return order[:k]
    cand = order[:min(r, g.size)]
    sel = np.argsort(-age[cand].astype(np.int64), kind="stable")[:k]
    return cand[sel]


def oracle(grads, scen, call, ages, r, k):
    """The union semantics in numpy for one call: each sending rank's
    picks (or its whole bf16 gradient, dense), the gate, the active
    count; (synced, new ages, stats)."""
    from repro.core.sparsify import bucket_budgets
    name, method, cand, validate, actives, bk, distinct = scen
    act = actives[call] or (True, True)
    gs = [rank_grads(grads, q, distinct, call, validate) for q in (0, 1)]
    up = [act[q] and (not validate or all(
        np.isfinite(v).all() and np.abs(v).max() <= 1e4
        for v in gs[q].values())) for q in (0, 1)]
    n_act = np.float32(max(sum(up), 1) if actives[call] or validate else 2)
    keys = sorted(gs[0])
    budgets = bucket_budgets([gs[0][n].size for n in keys], r, k)
    synced, new_ages, wire = {}, {}, 0
    for n, (r_b, k_b) in zip(keys, budgets):
        flat = [gs[q][n].reshape(-1).astype(np.float32) for q in (0, 1)]
        age = ages[n].reshape(-1)
        if method == "dense":
            w = sum(np.where(up[q], _bf16(flat[q]), np.float32(0))
                    for q in (0, 1)).astype(np.float32)
            synced[n] = (w / n_act).reshape(gs[0][n].shape)
            new_ages[n] = ages[n]
            wire += flat[0].size * 2
            continue
        dense = np.zeros(flat[0].size, np.float32)
        hit = np.zeros(flat[0].size, bool)
        for q in (0, 1):
            if not up[q]:
                continue
            idx = _oracle_pick(flat[q], age, method, r_b, k_b)
            np.add.at(dense, idx, _bf16(flat[q][idx]) / n_act)
            hit[idx] = True
        synced[n] = dense.reshape(gs[0][n].shape)
        new_ages[n] = np.where(hit, 0, age + 1).astype(np.int32).reshape(
            ages[n].shape)
        wire += min(k_b, flat[0].size) * 6
    senders = sum(act)
    stats = {"wire_bytes_per_shard": wire, "active_shards": sum(up),
             "wire_bytes_total": wire * senders,
             "quarantined_shards": senders - sum(up)}
    return synced, new_ages, stats


def check_distinct_match_oracle(runs):
    """Distinct gradients (rank 1's are rank 0's reversed, x0.7; under the
    gate rank 1's second call is out of band): rank 0 == the numpy
    oracle, every distinct scenario, exactly."""
    got = runs["torch"][0]
    grads, r, k = runs["grads"], runs["r"], runs["k"]
    scens = [s for s in SCENARIOS if s[-1]]
    assert scens
    for scen in scens:
        name = scen[0]
        ages = {n: np.zeros(v.shape, np.int32) for n, v in grads[0].items()}
        for call in range(len(scen[4])):
            synced, ages, stats = oracle(grads, scen, call, ages, r, k)
            for n in synced:
                np.testing.assert_array_equal(
                    got[f"{name}/{call}/synced/{n}"], synced[n],
                    err_msg=f"{name} {call} {n}")
                np.testing.assert_array_equal(
                    got[f"{name}/{call}/ages/{n}"], ages[n],
                    err_msg=f"{name} {call} {n}")
            for s_, v in stats.items():
                assert got[f"{name}/{call}/stats/{s_}"] == v, (name, call, s_)


# ---------------------------------------------------------------------------
# the model-sharded sync on a (data 2, model 2) mesh
# ---------------------------------------------------------------------------

# (name, method, candidates, active of the two calls); identical global
# gradients on both data ranks, each model rank holding its slices
SCENARIOS4 = [
    ("rage_k_threshold", "rage_k", "threshold", (None, None)),
    ("rage_k_sort", "rage_k", "sort", (None, None)),
    ("rage_k_masked", "rage_k", "sort", ((True, False), (False, True))),
    ("cafe", "cafe", "sort", (None, None)),
    ("dense", "dense", "sort", (None, None)),
]


def model_spec(shape, i: int) -> tuple:
    """Leaf i's spec entries over the model axis: a matrix or stack is
    split on its last dim (its second to last when i % 3 == 1) where 2
    divides it; a vector is replicated."""
    out = [None] * len(shape)
    if len(shape) >= 2:
        dim = len(shape) - (2 if i % 3 == 1 else 1)
        if shape[dim] % 2 == 0:
            out[dim] = "model"
    return tuple(out)


def load4(path):
    data = np.load(path)
    n = sum(1 for k in data.files if k.startswith("g_"))
    return ({f"l{i:02d}": data[f"g_{i:02d}"] for i in range(n)},
            int(data["r"]), int(data["k"]))


def run_torch4_rank(rank, path_in, out_dir, init_file):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sharding as SH
    from repro_torch.dist import sparse_sync as SS
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=4)
    grads, r, k = load4(path_in)
    mesh = make_host_mesh(2, 2, device="cpu")
    coords = {"data": mesh.rank, "model": mesh.model_rank}
    specs = {n: SH.P(*model_spec(v.shape, i))
             for i, (n, v) in enumerate(sorted(grads.items()))}
    shapes = {n: torch.empty(v.shape, device="meta")
              for n, v in grads.items()}
    local = {n: SH.local_slice(torch.from_numpy(v), specs[n], mesh, coords)
             for n, v in grads.items()}
    out = {}
    for name, method, cand, actives in SCENARIOS4:
        sync = SS.make_manual_sync(mesh, specs, shapes, method=method,
                                   candidates=cand, r=r, k=k)
        ages = SS.init_age_state_sharded(
            {n: torch.empty(t.shape, device="meta")
             for n, t in local.items()}, method=method, device="cpu")
        for call, act in enumerate(actives):
            act = None if act is None else torch.tensor(act)
            synced, ages, stats = sync({n: t.clone() for n, t in
                                        local.items()}, ages, active=act)
            _flat_out(out, name, call, {n: t.numpy() for n, t in
                                        synced.items()},
                      {n: t.numpy() for n, t in ages.items()},
                      {n: (v if isinstance(v, int) else v.numpy())
                       for n, v in stats.items()})
    run_merge_heads(out)
    out["coords"] = np.asarray([mesh.rank, mesh.model_rank])
    np.savez(os.path.join(out_dir, f"torch4_rank{rank}.npz"), **out)
    dist.destroy_process_group()


# regions.merge_heads's cases: the context o's (B, H, hd) placements on
# the (data, model) mesh, "partial" a partial sum, "batch" and "heads"
# a shard of that dim (heads on both: nested, as deepseek's pod x model)
MERGE_CASES = {"partial_heads": ("partial", "heads"),
               "batch_heads": ("batch", "heads"),
               "heads_heads": ("heads", "heads")}
MERGE_SHAPE = (4, 8, 6, 10)       # B, H, hd, d
MERGE_TOL = 1e-5                  # rtol and atol: float32 partial sums


def run_merge_heads(out):
    """Each case's ``merge_heads(o, wo)`` gathered whole on a real (data 2,
    model 2) mesh, beside the plain ``o.reshape(B, 1, H * hd) @ wo`` of
    the global context (the sum of the two data ranks' partial sums)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.dist import regions as RG

    B, H, hd, d = MERGE_SHAPE
    g = torch.Generator().manual_seed(5)
    parts = torch.randn(2, B, H, hd, generator=g)
    w = torch.randn(H * hd, d, generator=g)
    o = parts.sum(0)
    out["merge_heads/plain"] = (o.reshape(B, 1, H * hd) @ w).numpy()
    dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    coord = dm.get_coordinate()
    kinds = {"partial": Partial(), "batch": Shard(0), "heads": Shard(1)}
    wd = DTensor.from_local(w, dm, [Replicate(), Replicate()])
    for case, pls in MERGE_CASES.items():
        x = parts[coord[0]] if pls[0] == "partial" else o
        for p, c in zip(pls, coord):
            if p != "partial":
                x = x.chunk(2, dim=kinds[p].dim)[c]
        od = DTensor.from_local(x.contiguous(), dm, [kinds[p] for p in pls])
        out[f"merge_heads/{case}"] = RG.merge_heads(od, wd).full_tensor(
            ).numpy()


def check_merge_heads(runs):
    """Every rank's gathered ``merge_heads`` == the plain product within
    ``MERGE_TOL``, every case."""
    for got in runs["torch"]:
        for case in MERGE_CASES:
            np.testing.assert_allclose(
                got[f"merge_heads/{case}"], got["merge_heads/plain"],
                rtol=MERGE_TOL, atol=MERGE_TOL,
                err_msg=f"{case} rank {got['coords']}")


def run_jax4(path_in, out_dir):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.dist.sparse_sync import (init_age_state_sharded,
                                        make_manual_sync)
    from repro.launch.mesh import make_host_mesh

    grads, r, k = load4(path_in)
    mesh = make_host_mesh(2, 2)
    assert dict(mesh.shape) == {"data": 2, "model": 2}, mesh.shape
    specs = {n: P(*model_spec(v.shape, i))
             for i, (n, v) in enumerate(sorted(grads.items()))}
    shapes = {n: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for n, v in grads.items()}
    out = {}
    for name, method, cand, actives in SCENARIOS4:
        sync = jax.jit(make_manual_sync(mesh, specs, shapes, method=method,
                                        candidates=cand, r=r, k=k))
        ages = init_age_state_sharded(shapes, method=method)
        for call, act in enumerate(actives):
            g = {n: jnp.asarray(v) for n, v in grads.items()}
            act = None if act is None else jnp.asarray(act)
            synced, ages, stats = sync(g, ages, active=act)
            _flat_out(out, name, call, synced, ages, stats)
    np.savez(os.path.join(out_dir, "jax4.npz"), **out)


def start4(leaves, d, r: int, k: int) -> list:
    """Both four-shard modes in the background on the global gradient
    ``leaves`` (float32 numpy arrays), writing into ``d``."""
    here = os.path.dirname(os.path.abspath(__file__))
    np.savez(d / "in4.npz", r=r, k=k,
             **{f"g_{i:02d}": l for i, l in enumerate(leaves)})
    env = {**os.environ, "PYTHONPATH": os.path.join(here, "..", "src"),
           "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, os.path.join(here, "sync_ranks.py"), mode,
         str(d / "in4.npz"), str(d)], env=dict(env, **extra),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mode, extra in (
            ("torch4", {}),
            ("jax4", {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                      "JAX_PLATFORMS": "cpu"}))]


def collect4(d, procs) -> dict:
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    grads, r, k = load4(d / "in4.npz")
    return dict(torch=[dict(np.load(d / f"torch4_rank{q}.npz"))
                       for q in range(4)],
                jax=dict(np.load(d / "jax4.npz")), grads=grads, r=r, k=k)


def _slice(x, entries, coord_model: int):
    idx = tuple(slice(coord_model * (n // 2), (coord_model + 1) * (n // 2))
                if e == "model" else slice(None)
                for e, n in zip(entries, x.shape))
    return x[idx]


def check_four_ranks_match_reference(runs):
    """Each rank's local synced values and ages == the slice of the
    reference's global outputs at its model coordinate, and its stats ==
    the reference's, every scenario, both calls, exactly."""
    want = runs["jax"]
    grads = runs["grads"]
    names = sorted(grads)
    seen = set()
    for got in runs["torch"]:
        i, j = (int(c) for c in got["coords"])
        seen.add((i, j))
        for name, method, _c, actives in SCENARIOS4:
            for call in range(len(actives)):
                for li, n in enumerate(names):
                    ent = model_spec(grads[n].shape, li)
                    for part, lead in (("synced", ()), ("ages", (None,)
                                       if method == "cafe" else ())):
                        key = f"{name}/{call}/{part}/{n}"
                        np.testing.assert_array_equal(
                            got[key], _slice(want[key], lead + ent, j),
                            err_msg=f"{key} rank ({i}, {j})")
                for s in ("wire_bytes_per_shard", "active_shards",
                          "wire_bytes_total", "quarantined_shards"):
                    key = f"{name}/{call}/stats/{s}"
                    assert got[key] == want[key], (key, i, j)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


if __name__ == "__main__":
    mode, path_in, out_dir = sys.argv[1:4]
    world = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    if mode == "jax":
        run_jax(path_in, out_dir, world)
    elif mode == "jax4":
        run_jax4(path_in, out_dir)
    else:
        import torch.multiprocessing as mp
        if mode == "torch4":
            mp.spawn(run_torch4_rank, args=(path_in, out_dir, os.path.join(
                out_dir, "pg_init_torch4")), nprocs=4)
        else:
            mp.spawn(run_torch_rank, args=(path_in, out_dir, os.path.join(
                out_dir, f"pg_init_torch_{world}"), world), nprocs=world)
