"""The port's numpy copies of host modules equal the JAX package's
originals on the same random inputs: age merge/reset, eq.-(3) similarity
and DBSCAN, the byte ledger, the synthetic MNIST data and its paper split,
RAgeKConfig validation, and the LM's ArchConfig (fields, properties,
param_count) and InputShape. Integers and arrays compare exactly (the
copies run the same numpy operations)."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as JConfigs
from repro.configs import base as JB
from repro.configs.base import RAgeKConfig as JCfg
from repro.core import age as JA
from repro.core import clustering as JCl
from repro.core import compression as JCo
from repro.data import federated as JF
from repro.data import synthetic as JS

from repro_torch import configs as TConfigs
from repro_torch.configs import base as TB
from repro_torch.configs.base import RAgeKConfig as TCfg
from repro_torch.core import age as TA
from repro_torch.core import clustering as TCl
from repro_torch.core import compression as TCo
from repro_torch.data import federated as TF
from repro_torch.data import synthetic as TS


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("merge", ["min", "max"])
def test_age_state_merge_reset_matches(seed, merge):
    rng = np.random.default_rng(seed)
    n, d = 8, 33
    rows = rng.integers(0, 50, (n, d)).astype(np.int32)
    cluster_of = rng.integers(0, 4, n)
    cluster_of = np.unique(cluster_of, return_inverse=True)[1]
    labels = rng.integers(-1, 3, n)                 # -1 = DBSCAN noise
    states = [mod.AgeState.from_cluster_rows(rows, cluster_of, merge=merge)
              for mod in (JA, TA)]
    client = int(rng.integers(0, n))
    for st in states:
        st.record_request(client, np.array([0, 5, 7]))
        st.apply_clusters(labels)
    j, t = states
    np.testing.assert_array_equal(j.cluster_of, t.cluster_of)
    assert sorted(j.ages) == sorted(t.ages)
    for c in j.ages:
        np.testing.assert_array_equal(j.ages[c], t.ages[c])
    np.testing.assert_array_equal(j.freq, t.freq)
    assert j.clusters() == t.clusters()


@pytest.mark.parametrize("seed", range(4))
def test_clustering_matches(seed):
    rng = np.random.default_rng(seed)
    n, d = 10, 200
    # label pairs request from overlapping index pools, plus noise rows
    pools = [rng.choice(d, 30, replace=False) for _ in range(n // 2)]
    freq = np.zeros((n, d), np.int32)
    for i in range(n):
        pool = pools[i // 2] if i < n - 1 else rng.choice(d, 30)
        np.add.at(freq[i], rng.choice(pool, 60), 1)
    if seed == 0:
        freq[3] = 0                                 # a zero-norm row
    np.testing.assert_array_equal(JCl.similarity_matrix(freq),
                                  TCl.similarity_matrix(freq))
    np.testing.assert_array_equal(JCl.connectivity_matrix(freq),
                                  TCl.connectivity_matrix(freq))
    for eps, min_pts in ((0.3, 2), (0.6, 3), (0.05, 2)):
        np.testing.assert_array_equal(
            JCl.cluster_clients(freq, eps, min_pts),
            TCl.cluster_clients(freq, eps, min_pts))
        dist = rng.random((n, n))
        dist = (dist + dist.T) / 2
        np.testing.assert_array_equal(JCl.dbscan(dist, eps, min_pts),
                                      TCl.dbscan(dist, eps, min_pts))


@pytest.mark.parametrize("d", [1, 2, 255, 256, 257, 39_760, 2_515_338,
                               2 ** 24 + 1])
def test_bytes_ledger_matches(d):
    assert JCo.bytes_per_index(d) == TCo.bytes_per_index(d)
    for wire in ("float32", "bfloat16", "float16", "int8", "float64"):
        assert JCo.value_bytes_of(wire) == TCo.value_bytes_of(wire)
        for kw in ({}, {"dense": True}, {"m_active": 7},
                   {"index_bytes": 4, "value_bytes": 2}):
            assert (JCo.bytes_per_round(10, d, wire_dtype=wire, **kw)
                    == TCo.bytes_per_round(10, d, wire_dtype=wire, **kw))
    with pytest.raises(ValueError):
        TCo.bytes_per_round(10, d, m_active=-1)


def test_mnist_like_and_paper_split_match():
    (jx, jy), (jxt, jyt) = JS.mnist_like(n_train=400, n_test=50, seed=3)
    (tx, ty), (txt, tyt) = TS.mnist_like(n_train=400, n_test=50, seed=3)
    for a, b in ((jx, tx), (jy, ty), (jxt, txt), (jyt, tyt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    js = JF.paper_mnist_split(jx, jy, seed=5)
    ts = TF.paper_mnist_split(tx, ty, seed=5)
    assert TF.PAPER_MNIST_LABELS == JF.PAPER_MNIST_LABELS
    assert len(js) == len(ts) == 10
    for (a, b), (c, e) in zip(js, ts):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, e)


_CONFIGS = [
    {}, {"r": 5, "k": 10}, {"r": 5, "k": 10, "method": "top_k"},
    {"method": "nope"}, {"candidates": "heap"}, {"schedule": "aoi"},
    {"schedule": "later"}, {"wire_dtype": "int8"},
    {"age_layout": "hierarchical"}, {"age_layout": "tree"}, {"H": 0},
    {"M": 0}, {"batch_size": 0}, {"min_pts": 0}, {"lr": 0.0},
    {"eps": -1.0}, {"participation_m": -1}, {"deadline_s": -0.5},
    {"buffer_k": -2}, {"staleness_eta": -0.1}, {"version_window": 0},
    {"r": 100, "k": 100, "lr": 2e-3, "batch_size": 64, "method": "cafe"},
]


@pytest.mark.parametrize("kw", _CONFIGS)
def test_config_validation_matches(kw):
    outcomes = []
    for cls in (JCfg, TCfg):
        try:
            outcomes.append(dataclasses.asdict(cls(**kw)))
        except ValueError:
            outcomes.append(ValueError)
    assert outcomes[0] == outcomes[1]


_ARCH_PROPS = ("head_dim_", "padded_vocab", "attention_free", "d_inner",
               "ssm_nheads", "is_moe", "moe_hidden")


def _arch_summary(cfg):
    return (dataclasses.asdict(cfg),
            {p: getattr(cfg, p) for p in _ARCH_PROPS},
            cfg.param_count(), cfg.param_count(active_only=True))


def test_arch_config_fields_match():
    def spec(cls):
        return [(f.name, f.type, f.default,
                 f.default_factory() if f.default_factory
                 is not dataclasses.MISSING else None)
                for f in dataclasses.fields(cls)]
    assert spec(TB.ArchConfig) == spec(JB.ArchConfig)
    assert spec(TB.InputShape) == spec(JB.InputShape)
    assert TB.INPUT_SHAPES.keys() == JB.INPUT_SHAPES.keys()
    for name, shape in JB.INPUT_SHAPES.items():
        assert dataclasses.asdict(TB.INPUT_SHAPES[name]) == \
            dataclasses.asdict(shape)
    for x in (1, 511, 512, 513, 92_544, 256_000):
        assert TB.pad_to_multiple(x, 512) == JB.pad_to_multiple(x, 512)


@pytest.mark.parametrize("arch", JConfigs.list_archs())
def test_arch_config_properties_match(arch):
    """Every reference architecture rebuilt as the port's ArchConfig gives
    the same properties and parameter counts (dense, MoE, MLA, SSM,
    hybrid, audio, VLM, the paper nets), full size and smoke."""
    for jcfg in (JConfigs.get_config(arch), JConfigs.get_smoke_config(arch)):
        tcfg = TB.ArchConfig(**dataclasses.asdict(jcfg))
        assert _arch_summary(tcfg) == _arch_summary(jcfg)


@pytest.mark.parametrize("which", ["get_config", "get_smoke_config"])
def test_internlm2_config_matches(which):
    jcfg = getattr(JConfigs, which)("internlm2-1.8b")
    tcfg = getattr(TConfigs, which)("internlm2-1.8b")
    assert _arch_summary(tcfg) == _arch_summary(jcfg)
    kw = dict(n_layers=3, dtype="float32", sliding_window=8,
              grad_accum={"train_4k": 2})
    assert _arch_summary(tcfg.replace(**kw)) == _arch_summary(
        jcfg.replace(**kw))
    with pytest.raises(dataclasses.FrozenInstanceError):
        tcfg.n_layers = 1
