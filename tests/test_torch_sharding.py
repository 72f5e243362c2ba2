"""The port's sharding rules engine (``repro_torch.dist.sharding``) and the
spec helpers of ``repro_torch.launch.steps`` against the JAX package's.

The reference's specs come in-process from ``jax.sharding.AbstractMesh``
meshes of the production shapes, (data 16, model 16) and (pod 2, data 16,
model 16): no devices are forced. For every ``ASSIGNED_ARCHS`` full
config, both meshes and both rule sets (``auto`` and ``{"fsdp": None}``),
the port's ``param_specs`` with ``attention_overrides``, and its
``batch_spec_tree`` and ``cache_spec_tree`` at every ``INPUT_SHAPES``
entry, equal the reference's entry by entry. The reference's
``tests/test_dist.py`` spec tests are mirrored on the port's one-process
mesh; ``named`` is checked on a bare (pod, data, model) mesh for its
pod-major placements.

The model-sharded manual sync: four gloo ranks on a (data 2, model 2)
mesh (``tests/sync_ranks.py``'s ``torch4`` mode, each rank passing its
local slices) against the reference's ``shard_map`` exchange on four
forced host devices (``jax4``), identical gradients on both data ranks:
every rank's synced values and ages equal the slice of the reference's
at its coordinates, and the stats equal, exactly (rage_k with threshold
and sort candidates, a participation mask, cafe, dense). On the same
ranks, ``regions.merge_heads`` (MLA's decode output projection) equals
the plain product within float32 rounding. MoE's token
blocks: ``apply_moe`` under a data-2 mesh at granite's smoke config with
512 tokens (two blocks of 256, each with its own capacity) against the
reference's under a mesh of the same shape, float32, within 1e-5 (y),
1e-6 (``lb_loss``) and 1e-7 (``drop_frac``), as ``test_torch_moe.py``
holds one block; the reference's ``with_sharding_constraint`` is
replaced by the identity there, since its one CPU device cannot lay out
a data-2 sharding, and a constraint does not change values.
"""
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AbstractMesh

import lm_parity as LP
import sync_ranks

from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro.configs import get_config as j_config
from repro.dist import sharding as JSH
from repro.launch import steps as JS
from repro.configs import get_smoke_config as j_smoke_config
from repro.models import moe as JM
from repro.models import registry as JR

from repro_torch import tree as _tree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist import sharding as SH
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as TM
from repro_torch.models import registry as R

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"auto": None, "fsdp_none": {"fsdp": None}}


@pytest.fixture(scope="module", autouse=True)
def four_ranks(tmp_path_factory):
    """The (data 2, model 2) runs of ``tests/sync_ranks.py``, started in
    the background at the module's first case, so that they run beside
    the spec cases."""
    rng = np.random.default_rng(11)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 64, 96), (96, 64), (64,), (3, 32, 48),
                        (128, 40))]
    d = tmp_path_factory.mktemp("ranks4")
    procs = sync_ranks.start4(leaves, d, 256, 32)
    yield d, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.communicate()


def _jmesh(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes)


def _pmesh(name):
    sizes, axes = MESHES[name]
    return SH.Mesh(dict(zip(axes, sizes)))


def _norm(spec) -> tuple:
    """A spec as a plain tuple of None, names and tuples of names."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _jleaves(tree):
    """The reference's spec (or sharding) leaves in tree order."""
    def spec(x):
        return _norm(x.spec if hasattr(x, "spec") else x)
    return [spec(x) for x in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        or hasattr(x, "spec"))]


_ABSTRACT: dict = {}


def _abstract(arch):
    if arch not in _ABSTRACT:
        _ABSTRACT[arch] = (JS.abstract_params(j_config(arch)),
                           S.abstract_params(get_config(arch)))
    return _ABSTRACT[arch]


def _cases():
    for arch in ASSIGNED_ARCHS:
        for mesh in MESHES:
            for rules in RULES:
                yield pytest.param(arch, mesh, rules,
                                   id=f"{arch}-{mesh}-{rules}")


@pytest.mark.parametrize("arch,mesh_name,rules", list(_cases()))
def test_specs_match_reference(arch, mesh_name, rules):
    jmesh, pmesh = _jmesh(mesh_name), _pmesh(mesh_name)
    jcfg, cfg = j_config(arch), get_config(arch)
    jparams, params = _abstract(arch)
    rule = RULES[rules]
    with JSH.use_mesh(jmesh, rules=rule):
        jspecs = JSH.param_specs(
            jparams, overrides=JS.attention_overrides(jmesh, jcfg))
        jres = [JSH.resolve_spec(n, s) for n, s in _RESOLVE]
    with SH.use_mesh(pmesh, rules=rule):
        specs = SH.param_specs(
            params, overrides=S.attention_overrides(pmesh, cfg))
        res = [SH.resolve_spec(n, s) for n, s in _RESOLVE]
    assert S.attention_overrides(pmesh, cfg) == JS.attention_overrides(
        jmesh, jcfg)
    assert [_norm(s) for s in _tree.leaves(specs)] == _jleaves(jspecs)
    assert [_norm(s) for s in res] == [_norm(s) for s in jres]
    for shape in INPUT_SHAPES.values():
        if shape.kind != "decode":
            jb = JS.batch_spec_tree(jmesh, JR.input_specs(jcfg, shape), jcfg)
            b = S.batch_spec_tree(pmesh, R.input_specs(cfg, shape), cfg)
            assert sorted(b) == sorted(jb)
            assert [_norm(b[k]) for k in sorted(b)] == [
                _norm(jb[k].spec) for k in sorted(jb)], shape.name
            continue
        jin, jcache = JR.decode_input_specs(jcfg, shape)
        pin, pcache = R.decode_input_specs(cfg, shape)
        jb = JS.batch_spec_tree(jmesh, jin, jcfg)
        b = S.batch_spec_tree(pmesh, pin, cfg)
        assert [_norm(b[k]) for k in sorted(b)] == [
            _norm(jb[k].spec) for k in sorted(jb)], shape.name
        jc = JS.cache_spec_tree(jmesh, jcfg, jcache)
        c = S.cache_spec_tree(pmesh, cfg, pcache)
        assert [_norm(s) for s in _tree.leaves(c)] == _jleaves(jc), \
            shape.name


# names x shapes through resolve_spec: divisibility, used axes, unknowns
_RESOLVE = [
    (("batch", "seq", "embed"), (256, 4096, 2048)),
    (("batch", "seq_model", "embed"), (32, 32768, 3072)),
    (("batch", None, "d_ff"), (1, 7, 8192)),
    (("heads", "d_ff"), (10, 7)),
    (("fsdp", "fsdp"), (32, 32)),
    (("model", "heads"), (16, 16)),
    (("expert", "fsdp", None), (40, 1536, 512)),
    (("unknown", "vocab"), (3, 92544)),
]


# -- the reference's tests/test_dist.py spec tests, on the port ------------


def test_resolve_spec_divisibility_fallback():
    mesh = make_host_mesh(1, 1, device="cpu")
    with SH.use_mesh(mesh):
        assert SH.resolve_spec(("heads", "d_ff"), (10, 7)) == SH.P(None,
                                                                   None)


def test_param_specs_structure_matches():
    mesh = make_host_mesh(1, 1, device="cpu")
    params = {"layers": {"attn": {"wq": torch.zeros((8, 8))}},
              "embed": {"w": torch.zeros((32, 8))}}
    with SH.use_mesh(mesh):
        specs = SH.param_specs(params)
    assert _tree.flatten(specs)[1] == _tree.flatten(params)[1]
    assert all(isinstance(s, SH.PartitionSpec) for s in _tree.leaves(specs))


def test_constraint_noop_without_mesh_or_on_plain_tensor():
    x = torch.ones((4, 4))
    assert SH.constraint(x, ("batch", None)) is x
    with SH.use_mesh(_pmesh("16x16")):
        assert SH.constraint(x, ("batch", None)) is x


def test_named_places_pod_major():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _pmesh("2x16x16")
    assert SH.placements(mesh, SH.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert SH.placements(mesh, SH.P(None, "data")) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="axis order"):
        SH.placements(mesh, SH.P(("data", "pod")))
    with SH.use_mesh(mesh), pytest.raises(RuntimeError, match="DeviceMesh"):
        SH.named({"w": SH.P(None)})
    with pytest.raises(RuntimeError, match="active mesh"):
        SH.named({"w": SH.P(None)})


def test_local_slice_matches_row_major_coords():
    mesh = _pmesh("2x16x16")
    x = torch.arange(64 * 48).reshape(64, 48)
    spec = SH.P(("pod", "data"), "model")
    rank = 1 * 256 + 3 * 16 + 5
    coords = SH.mesh_coords(mesh, rank)
    assert coords == {"pod": 1, "data": 3, "model": 5}
    got = SH.local_slice(x, spec, mesh, coords)
    assert torch.equal(got, x[(16 + 3) * 2:(16 + 4) * 2, 15:18])
    assert SH.shard_count(mesh, spec) == 512


# -- the model-sharded manual sync on four ranks ---------------------------


@pytest.fixture(scope="module")
def four_runs(four_ranks):
    return sync_ranks.collect4(*four_ranks)


def test_four_ranks_match_reference(four_runs):
    sync_ranks.check_four_ranks_match_reference(four_runs)


def test_merge_heads_on_four_ranks(four_runs):
    """``regions.merge_heads`` on the four gloo ranks' (data 2, model 2)
    mesh, the context's heads sharded on model and its batch, heads or a
    partial sum on data, equals the plain ``reshape @ wo`` within
    ``sync_ranks.MERGE_TOL``."""
    sync_ranks.check_merge_heads(four_runs)


# -- MoE's token blocks under a data-2 mesh --------------------------------


class _Shape:
    """A bare mesh for the reference: its ``shape`` dict alone."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_token_blocks_match_reference(cf, monkeypatch):
    jcfg = j_smoke_config("granite-moe-3b-a800m").replace(
        dtype="float32", capacity_factor=cf)
    tcfg = get_smoke_config("granite-moe-3b-a800m").replace(
        dtype="float32", capacity_factor=cf)
    jp = JM.moe_params(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(4).standard_normal(
        (2, 256, jcfg.d_model)).astype(np.float32)
    monkeypatch.setattr(JM, "constraint", lambda v, names: v)
    shape = {"data": 2, "model": 1}
    with JSH.use_mesh(_Shape(shape)):
        assert JM._n_token_blocks(512) == 2
        jy, jaux = JM.apply_moe(jp, jcfg, jnp.asarray(x))
    with SH.use_mesh(SH.Mesh(shape)):
        assert TM._n_token_blocks(512) == 2
        ty, taux = TM.apply_moe(LP.carry(jp), tcfg, torch.from_numpy(x))
    LP.close(ty, jy, 1e-5)
    np.testing.assert_allclose(float(taux["lb_loss"]),
                               float(jaux["lb_loss"]), rtol=1e-6, atol=1e-6)
    assert float(taux["drop_frac"]) == pytest.approx(
        float(jaux["drop_frac"]), abs=1e-7)
    # one block (no mesh) routes against the whole batch's capacity
    one, one_aux = TM.apply_moe(LP.carry(jp), tcfg, torch.from_numpy(x))
    if cf < 1:
        assert not torch.equal(one, ty)
