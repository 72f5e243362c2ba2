"""The port's fig3 paths end to end against the JAX engine.

One round from identical inputs: the reference engine's initial params
and its round-1 batches go through the port's round body, for rAge-k
(segmented and the sequential scan), CAFe, top-k and dense. Losses, the
aggregated gradient and the new global params match within rtol=1e-5,
atol=1e-6; requested indices, cluster ages and request counts (CAFe's
cost) exactly. rTop-k and random-k draw from torch's generator, so they
are held to what the draw must be. Then 20 rAge-k rounds on the port's
own sampler reach the reference's five label-pair clusters at the first
recluster (M = 20).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import RAgeKConfig as JCfg
from repro.core import strategies as JS
from repro.fl import client as JC
from repro.fl.engine import FederatedEngine as JEngine

import repro_torch
from repro_torch.configs.base import RAgeKConfig
from repro_torch.data.federated import paper_mnist_split
from repro_torch.data.synthetic import mnist_like
from repro_torch.fl.engine import FederatedEngine
from repro_torch.weights import params_from_jax

FIG3 = dict(r=75, k=10, H=4, M=20, lr=1e-4, batch_size=256)
PAIRS = [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]


@pytest.fixture(scope="module")
def fig3_data():
    (x, y), test = mnist_like(n_train=3000, n_test=2000, seed=0)
    return paper_mnist_split(x, y, seed=0), test


TOL = dict(rtol=1e-5, atol=1e-6)


def _sparse_sum(G, idx):
    g_sum = np.zeros(G.shape[1], np.float32)
    np.add.at(g_sum, idx.reshape(-1),
              np.take_along_axis(G, idx, axis=1).reshape(-1))
    return g_sum


def _one_round(shards, test, hp, *, selection="segmented", cluster_of=None):
    """The reference engine's round 1, and the port's round body on the
    reference's initial params and round-1 batches. ``cluster_of`` sets
    both engines' clusters first. Returns (jeng, jm, jG, teng, tm), jG the
    reference's last-step gradients."""
    jeng = JEngine("mlp", shards, test, JCfg(**hp), seed=0,
                   selection=selection)
    bx, by, _ =jeng._store.draw(jeng._data, jeng.samp, FIG3["H"])
    jG = np.asarray(jeng._local_phase(jeng.params_s, jeng.opt_s, {},
                                      (bx, by), None)[3])
    params0 = jax.tree_util.tree_map(np.asarray, jeng.g_params)
    teng = FederatedEngine("mlp", shards, test, RAgeKConfig(**hp),
                           seed=0, device="cpu", selection=selection,
                           params=params_from_jax(params0, "cpu"))
    if cluster_of is not None:
        cl = np.asarray(cluster_of, np.int32)
        jeng.age = jeng.age._replace(cluster_of=jnp.asarray(cl))
        jeng._num_seg = teng._num_seg = int(cl.max()) + 1
        jeng._max_seg = teng._max_seg = int(np.bincount(cl).max())
        teng.age = teng.age._replace(cluster_of=torch.from_numpy(cl))
    jm = jeng.step()                    # draws the same batches
    tm = teng._round_impl(torch.from_numpy(np.array(bx)),
                          torch.from_numpy(np.array(by)).long())
    return jeng, jm, jG, teng, tm


def _assert_state_matches(jeng, teng):
    np.testing.assert_allclose(teng.g_params.numpy(),
                               np.asarray(JC.flatten_tree(jeng.g_params)),
                               **TOL)
    np.testing.assert_array_equal(teng.age.cluster_age.numpy(),
                                  np.asarray(jeng.age.cluster_age))
    np.testing.assert_array_equal(teng.age.freq.numpy(),
                                  np.asarray(jeng.age.freq))


def test_one_round_matches_reference(fig3_data):
    shards, test = fig3_data
    jeng, jm, jG, teng, tm = _one_round(shards, test, FIG3)
    np.testing.assert_allclose(tm["losses"].numpy(), jm["losses"], **TOL)
    np.testing.assert_array_equal(tm["idx"].numpy(), jm["idx"])
    np.testing.assert_allclose(tm["g_sum"].numpy(), _sparse_sum(jG, jm["idx"]),
                               **TOL)
    _assert_state_matches(jeng, teng)


@pytest.mark.parametrize("method", ["cafe", "top_k", "dense"])
def test_one_round_matches_reference_methods(fig3_data, method):
    """The deterministic baselines: indices, ages and cost (CAFe keeps it
    in freq) exactly; losses, the aggregated gradient and params within
    tolerance. Dense requests nothing and sums the whole gradients."""
    shards, test = fig3_data
    jeng, jm, jG, teng, tm = _one_round(shards, test,
                                        {**FIG3, "method": method})
    np.testing.assert_allclose(tm["losses"].numpy(), jm["losses"], **TOL)
    if method == "dense":
        assert tm["idx"] is None and jm["idx"] is None
        want = jG.sum(0)
    else:
        np.testing.assert_array_equal(tm["idx"].numpy(), jm["idx"])
        want = _sparse_sum(jG, jm["idx"])
    np.testing.assert_allclose(tm["g_sum"].numpy(), want, **TOL)
    _assert_state_matches(jeng, teng)
    assert teng.age.cluster_of.tolist() == list(range(10))
    if method == "cafe":
        assert int(teng.age.freq.sum()) == 10 * FIG3["k"]


@pytest.mark.parametrize("cluster_of", [list(range(10)), PAIRS])
def test_scan_round_matches_reference_and_segmented(fig3_data, cluster_of):
    """selection='scan' (the sequential reference) against the reference's
    scan engine, and equal to the port's segmented round: with label-pair
    clusters the second member of each pair must avoid the first's picks."""
    shards, test = fig3_data
    jeng, jm, jG, teng, tm = _one_round(shards, test, FIG3, selection="scan",
                                        cluster_of=cluster_of)
    np.testing.assert_allclose(tm["losses"].numpy(), jm["losses"], **TOL)
    np.testing.assert_array_equal(tm["idx"].numpy(), jm["idx"])
    np.testing.assert_allclose(tm["g_sum"].numpy(), _sparse_sum(jG, jm["idx"]),
                               **TOL)
    _assert_state_matches(jeng, teng)
    _, _, _, seng, sm = _one_round(shards, test, FIG3, cluster_of=cluster_of)
    assert torch.equal(sm["idx"], tm["idx"])
    assert torch.equal(seng.age.cluster_age, teng.age.cluster_age)
    assert torch.equal(seng.age.freq, teng.age.freq)
    if cluster_of == PAIRS:
        idx = tm["idx"].tolist()
        for a, b in zip(idx[0::2], idx[1::2]):
            assert not set(a) & set(b)


@pytest.mark.parametrize("method", ["rtop_k", "random_k"])
def test_one_round_stochastic_methods(fig3_data, method):
    """The draws differ from the reference's, so: losses within tolerance,
    k distinct real indices per client, drawn from the reference's own
    top-r report (rtop_k), and the aggregate the sum of exactly those
    uploads of the reference's gradients."""
    shards, test = fig3_data
    hp = {**FIG3, "method": method}
    jeng, jm, jG, teng, tm = _one_round(shards, test, hp)
    np.testing.assert_allclose(tm["losses"].numpy(), jm["losses"], **TOL)
    idx = tm["idx"].numpy()
    assert idx.shape == (10, FIG3["k"]) and idx.dtype == np.int32
    assert ((idx >= 0) & (idx < teng.d)).all()
    assert all(len(set(row)) == FIG3["k"] for row in idx.tolist())
    if method == "rtop_k":
        report = np.asarray(JS.client_candidates(jnp.asarray(jG), FIG3["r"],
                                                 "threshold"))
        for got, want, cand in zip(idx, jm["idx"], report):
            assert set(got.tolist()) <= set(cand.tolist())
            assert set(want.tolist()) <= set(cand.tolist())
    np.testing.assert_allclose(tm["g_sum"].numpy(), _sparse_sum(jG, idx),
                               **TOL)
    assert not teng.age.freq.any()


def test_cafe_engine_end_to_end():
    """Six rounds of CAFe in the port: lam = 0 on singleton clusters with
    no recluster (M large) requests what rAge-k requests; lam = 5 changes
    the schedule once costs accumulate; the cost is k per client-round."""
    (x, y), test = mnist_like(n_train=800, n_test=300, seed=0)
    shards = paper_mnist_split(x, y, seed=0)
    base = dict(r=8, k=5, H=2, M=1000, lr=2e-3, batch_size=16)

    def run(**kw):
        eng = FederatedEngine("mlp", shards, test,
                              RAgeKConfig(**base, **kw), seed=2, device="cpu")
        return eng, eng.run(6, eval_every=6)

    _, r_cafe = run(method="cafe", cafe_lam=0.0)
    _, r_rage = run(method="rage_k")
    for a, b in zip(r_cafe.requested, r_rage.requested):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(r_cafe.loss, r_rage.loss, rtol=0, atol=0)
    e2, r2 = run(method="cafe", cafe_lam=5.0)
    assert any(not np.array_equal(a, b)
               for a, b in zip(r2.requested, r_cafe.requested))
    assert int(e2.freq_matrix.sum()) == 6 * e2.n * base["k"]
    assert e2.cluster_of.tolist() == list(range(10))


@pytest.mark.parametrize("method,per_client", [
    ("rtop_k", 10 * (4 + 2)), ("top_k", 10 * (4 + 2)),
    ("random_k", 10 * (4 + 2)), ("cafe", 10 * (4 + 2) + 75 * 2),
    ("dense", 39_760 * 4)])
def test_uplink_bytes_per_method(fig3_data, method, per_client):
    shards, test = fig3_data
    eng = FederatedEngine("mlp", shards, test,
                          RAgeKConfig(**{**FIG3, "method": method}),
                          seed=0, device="cpu")
    m = eng.step()
    assert eng.cum_bytes == 10 * per_client
    assert (m["idx"] is None) == (method == "dense")


def test_twenty_rounds_reach_label_pair_clusters(fig3_data):
    shards, test = fig3_data
    eng = FederatedEngine("mlp", shards, test, RAgeKConfig(**FIG3),
                          seed=0, device="cpu")
    res = eng.run(20, eval_every=10, heatmap_at=(20,))
    assert eng.round_idx == 20
    heat = res.heatmaps[20]
    assert heat.shape == (10, 10) and np.allclose(np.diag(heat), 1.0)
    assert eng.cluster_of.tolist() == PAIRS
    assert res.cluster_labels[-1].tolist() == PAIRS
    assert np.isfinite(res.loss).all() and 0.0 <= res.acc[-1] <= 1.0
    assert all(r.shape == (10, FIG3["k"]) for r in res.requested)
    assert res.uplink_bytes[-1] == 20 * 10 * (10 * (4 + 2) + 75 * 2)


def test_package_imports_no_jax():
    """Every repro_torch module imports without jax or any repro module."""
    root = os.path.dirname(repro_torch.__file__)
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules"
        " if m.startswith('repro_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH":
                                         os.path.dirname(root)})
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 36
    assert {"repro_torch.configs.internlm2_1_8b", "repro_torch.launch.serve",
            "repro_torch.models.layers", "repro_torch.models.transformer",
            "repro_torch.models.registry",
            "repro_torch.kernels.decode_attention"} <= mods


def test_no_silent_cpu(fig3_data, monkeypatch):
    """device=None means the card: without one the engine raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shards, test = fig3_data
    with pytest.raises(RuntimeError, match="CUDA"):
        FederatedEngine("mlp", shards, test, RAgeKConfig(**FIG3))


@pytest.mark.parametrize("kw,hp", [
    ({"kind": "cnn"}, {}), ({}, {"schedule": "aoi"}),
    ({}, {"schedule": "deadline"}), ({"compute": "gathered"}, {}),
    ({}, {"age_layout": "hierarchical"}), ({"ef": True}, {}),
    ({"faults": object()}, {}), ({}, {"schedule": "uniform"})])
def test_unported_options_raise(fig3_data, kw, hp):
    shards, test = fig3_data
    kw = {"kind": "mlp", **kw}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FederatedEngine(kw.pop("kind"), shards, test,
                        RAgeKConfig(**{**FIG3, **hp}), device="cpu", **kw)
