"""The port's fig3 slice end to end against the JAX engine.

One round from identical inputs: the reference engine's initial params
and its round-1 batches go through the port's round body. Losses, the
aggregated gradient and the new global params match within rtol=1e-5,
atol=1e-6; requested indices, cluster ages and request counts exactly.
Then 20 rounds on the port's own sampler reach the reference's five
label-pair clusters at the first recluster (M = 20).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import RAgeKConfig as JCfg
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


def test_one_round_matches_reference(fig3_data):
    shards, test = fig3_data
    jeng = JEngine("mlp", shards, test, JCfg(**FIG3), seed=0)
    bx, by, _ = jeng._store.draw(jeng._data, jeng.samp, FIG3["H"])
    jG = np.asarray(jeng._local_phase(jeng.params_s, jeng.opt_s, {},
                                      (bx, by), None)[3])
    params0 = jax.tree_util.tree_map(np.asarray, jeng.g_params)
    jm = jeng.step()                    # draws the same batches

    teng = FederatedEngine("mlp", shards, test, RAgeKConfig(**FIG3),
                           seed=0, device="cpu",
                           params=params_from_jax(params0, "cpu"))
    tm = teng._round_impl(torch.from_numpy(np.array(bx)),
                          torch.from_numpy(np.array(by)).long())
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm["losses"].numpy(), jm["losses"], **tol)
    np.testing.assert_array_equal(tm["idx"].numpy(), jm["idx"])
    g_sum = np.zeros(teng.d, np.float32)
    np.add.at(g_sum, jm["idx"].reshape(-1),
              np.take_along_axis(jG, jm["idx"], axis=1).reshape(-1))
    np.testing.assert_allclose(tm["g_sum"].numpy(), g_sum, **tol)
    np.testing.assert_allclose(teng.g_params.numpy(),
                               np.asarray(JC.flatten_tree(jeng.g_params)),
                               **tol)
    np.testing.assert_array_equal(teng.age.cluster_age.numpy(),
                                  np.asarray(jeng.age.cluster_age))
    np.testing.assert_array_equal(teng.age.freq.numpy(),
                                  np.asarray(jeng.age.freq))


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
        "print(sum(m.startswith('repro_torch') for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH":
                                         os.path.dirname(root)})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20


def test_no_silent_cpu(fig3_data, monkeypatch):
    """device=None means the card: without one the engine raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shards, test = fig3_data
    with pytest.raises(RuntimeError, match="CUDA"):
        FederatedEngine("mlp", shards, test, RAgeKConfig(**FIG3))


@pytest.mark.parametrize("kw,hp", [
    ({"kind": "cnn"}, {}), ({}, {"method": "rtop_k"}),
    ({"selection": "scan"}, {}), ({"compute": "gathered"}, {}),
    ({}, {"age_layout": "hierarchical"}), ({"ef": True}, {}),
    ({"faults": object()}, {}), ({}, {"schedule": "uniform"})])
def test_unported_options_raise(fig3_data, kw, hp):
    shards, test = fig3_data
    kw = {"kind": "mlp", **kw}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FederatedEngine(kw.pop("kind"), shards, test,
                        RAgeKConfig(**{**FIG3, **hp}), device="cpu", **kw)
