"""The port's hybrid family and zamba2-2.7b (54 Mamba2 layers with one
attention block, its weights shared, after every 6 of them; 32 heads of
80 at full width, a sliding window of 8,192) against the JAX package, on
the CPU, inputs made from a seed with numpy and both packages started
from the reference's parameters.

The arch's smoke config (2 layers, one group) goes through
``tests/lm_parity.py``'s checks in float32 and bfloat16, and a variant
with 4 layers (two groups, two applications of the shared block) and
``sliding_window=4`` in float32, whose 14 decode steps wrap the K/V ring
(slot pos % 4) and whose prefill and loss run the windowed attention.
The tolerances are lm_parity's, but for these:
- float32: a gradient leaf within 3e-5 of its norm (lm_parity: 1e-5).
  ``A_log``'s gradient carries float32's own error: against a float64 run
  both packages' float32 gradients lie 1.1-1.2e-5 of its norm away
  (``tests/test_torch_ssm.py``); every other leaf within 5e-6.
- bfloat16: caches within 1e-1 (lm_parity: 5e-2) and a gradient leaf
  within 5e-2 of its norm (3e-2). The SSM layers round to bfloat16 at a
  dozen places a token, and the rounding compounds through the states:
  the reference's own bfloat16 K cache lies 6.7e-2 from its float32
  model's fed the same tokens (the port's 5.6e-2 from the reference's),
  and the reference's own bfloat16 gradient lies 7.5% of its norm from
  its float32 one on ``D`` (the port's 3.1%).

``decode_attention`` at zamba2's full-width head shape (32 heads of 80,
rep 1, whose head dim the CUDA kernel takes through
``csrc/decode_attention_d80.cu``) runs its plain version and its
split-and-combine here, held to the Pallas kernel in interpret mode at
``tests/test_torch_decode_attention.py``'s tolerances (float32 2e-5,
bfloat16 2e-2 scaled to the output); that file's sweep and split cut
cover D 80 too, and its ``cuda`` tests the kernel on the card. One
``sync_grads`` call on the bfloat16 smoke tree (20 buckets: the stacked
SSM layers with their float32 leaves, the unstacked shared block) equals
the reference's synced values, ages and wire bytes exactly.
"""
import math

import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_smoke_config
from repro.dist import sparse_sync as JS
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro.optim import optimizers as JO

import lm_parity as P
from repro_torch import tree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist import sparse_sync as TS
from repro_torch.kernels import decode_attention as DA
from repro_torch.launch import serve, train
from repro_torch.models import transformer as TT

ARCH = "zamba2-2.7b"
CASES = {
    "float32": ("float32", dict(grad_rel=3e-5), {}),
    "bfloat16": ("bfloat16", dict(cache=1e-1, grad_rel=5e-2), {}),
    "ring-float32": ("float32", dict(grad_rel=3e-5),
                     dict(n_layers=4, sliding_window=4)),
}
R, K = 512, 64                  # the sync's budget on the smoke tree


@pytest.fixture(scope="module", params=list(CASES))
def ref(request):
    dtype, tol, fields = CASES[request.param]
    return P.reference(ARCH, dtype, tol, **fields)


def test_params_carry_across_leaf_for_leaf(ref):
    """The SSM layers stacked, the shared block's leaves unstacked."""
    P.check_init_tree(ref)
    cfg, params = ref["tcfg"], ref["tparams"]
    assert params["layers"]["ssm"]["in_proj"].shape[0] == cfg.n_layers
    assert tuple(params["shared"]["attn"]["wq"].shape) == \
        (cfg.d_model, cfg.n_heads * cfg.head_dim_)
    assert set(params["shared"]) == {"attn", "ln1", "ln2", "mlp"}


def test_decode_loop_matches_jax(ref):
    P.check_decode_loop(ref)
    if ref["tcfg"].sliding_window:       # the ring is shorter than the loop
        assert ref["steps"][0][1]["k"].shape[2] == 4 < P.P + P.GEN


def test_generate_matches_jax_greedy(ref):
    P.check_generate(ref)


def test_prefill_matches_jax(ref):
    P.check_prefill(ref)


def test_decode_matches_own_prefill(ref):
    P.check_decode_matches_own_prefill(ref)


def test_loss_fn_matches(ref):
    P.check_loss(ref)


def test_remat_is_bitwise():
    """``cfg.remat`` recomputes each group (its SSM layers and the shared
    block) in the backward pass: no bit of the loss or a gradient
    changes."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32", remat=False,
                                         n_layers=4)
    params = TT.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    batch = {k: torch.from_numpy(P.tokens((2, 24), s))
             for k, s in (("tokens", 1), ("labels", 2))}
    outs = [tree.value_and_grad(
        lambda p, b: TT.loss_fn(p, cfg.replace(remat=remat), b)[0], params,
        batch) for remat in (False, True)]
    (l0, g0), (l1, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g0),
                                                 tree.leaves(g1)))


def test_hybrid_needs_whole_groups():
    """A depth that is no multiple of ``attn_every`` is refused (the
    reference's reshape into groups fails there too)."""
    cfg = get_smoke_config(ARCH).replace(n_layers=3, dtype="float32")
    for call in (lambda: TT.init(cfg, torch.Generator(), device="cpu"),
                 lambda: TT.init_cache(cfg, 1, 4, device="cpu")):
        with pytest.raises(ValueError, match="whole groups"):
            call()


def test_full_width_cache_and_buckets():
    """zamba2-2.7b at full width: the cache's shapes and dtypes (K/V for
    each of the 9 shared-block applications, a ring of the 8,192-position
    window), and its largest bucket, the stacked ``in_proj``, below 2^31
    elements (the kernels' and the wire's int32 indices)."""
    cfg = get_config(ARCH)
    cache = TT.init_cache(cfg, 8, 10_000, device="meta")
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "conv": ((54, 8, 3, 5_248), torch.bfloat16),
        "state": ((54, 8, 80, 64, 64), torch.float32),
        "k": ((9, 8, 8192, 32, 80), torch.bfloat16),
        "v": ((9, 8, 8192, 32, 80), torch.bfloat16)}
    assert cfg.head_dim_ == 80 and 80 in DA.HEAD_DIMS
    in_proj = cfg.n_layers * cfg.d_model * (
        2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_nheads)
    assert in_proj == 1_444_331_520 < 2 ** 31


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_decode_attention_at_head_dim_80(dtype, tol):
    """zamba2's shared attention at full width (H = G = 32, D 80) over a
    300-position cache, the kernel's plain version and its split-and-
    combine (2 and 3 splits of the D 80 tile) against the Pallas kernel
    in interpret mode, cache_len 1, 287 and 300."""
    rng = np.random.default_rng(80)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((1, 32, 80), (1, 300, 32, 80), (1, 300, 32, 80))]
    jq, jk, jv = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrays)
    assert DA.tile_positions(80, tq.element_size()) == \
        {"float32": 72, "bfloat16": 144}[dtype]
    for clen in (1, 287, 300):
        want = np.asarray(jops.decode_attention(jq, jk, jv, clen),
                          np.float32)
        atol = tol * min(1.0, float(np.abs(want).max()))
        for got in (DA.decode_attention_plain(tq, tk, tv, clen),
                    DA.decode_attention_split_plain(tq, tk, tv, clen, 2),
                    DA.decode_attention_split_plain(tq, tk, tv, clen, 3)):
            assert got.dtype == tq.dtype and got.shape == (1, 32, 80)
            np.testing.assert_allclose(P.np_(got), want, rtol=tol,
                                       atol=atol, err_msg=f"cache_len={clen}")


def test_sync_grads_on_hybrid_tree():
    """One ``sync_grads`` call (rage_k on the threshold plane) on the
    reference's bfloat16 smoke-config gradient against its jitted
    ``make_sync_train_step`` (read through a linear loss and SGD at lr 1
    from zeros, as ``tests/test_torch_sparse_sync.py`` reads it): synced
    values, ages and wire bytes equal, each bucket in its own dtype."""
    cfg = j_smoke_config(ARCH).replace(dtype="bfloat16", remat=False)
    params = JT.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: jnp.asarray(rng.integers(0, 512, (2, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    jg = jax.jit(jax.grad(lambda p, b: JT.loss_fn(p, cfg, b)[0]))(params,
                                                                  batch)
    tg = P.carry(jg)
    dtypes = {str(a.dtype) for a in tree.leaves(tg)}
    assert len(tree.leaves(tg)) == 20 and dtypes == {"torch.float32",
                                                     "torch.bfloat16"}
    kw = dict(method="rage_k", r=R, k=K, candidates="threshold")
    opt = JO.sgd(1.0)
    step = jax.jit(JS.make_sync_train_step(
        lambda p, b: sum(jnp.sum(a * c) for a, c in zip(
            jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(b))),
        opt, None, **kw))
    p0 = jax.tree_util.tree_map(jnp.zeros_like, jg)
    p1, _, jages, _, jst = step(p0, opt.init(p0), JS.init_age_state(jg), jg)
    tsyn, tages, tst = TS.sync_grads(tg, TS.init_age_state(tg), **kw)
    for got, want in ((tsyn, jax.tree_util.tree_map(lambda x: -x, p1)),
                      (tages, jages)):
        for a, b in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(P.np_(a), np.asarray(b).astype(
                P.np_(a).dtype))
    assert tst["wire_bytes_per_shard"] == int(jst["wire_bytes_per_shard"])
    assert [a.dtype for a in tree.leaves(tsyn)] == \
        [a.dtype for a in tree.leaves(tg)]


def test_serve_and_train_cli_on_the_cpu(capsys):
    """``launch.serve --smoke`` and ``launch.train --smoke`` with
    ``--device cpu``: the reference's lines, finite losses."""
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"arch={ARCH} batch=2 prefill=")
    assert lines[1].startswith("generated token ids (first row): ")
    out = train.main(["--arch", ARCH, "--smoke", "--steps", "2",
                      "--log-every", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    n = sum(p.numel() for p in tree.leaves(out["params"]))
    assert lines[0] == f"arch={ARCH} params={n:,} method=rage_k"
    assert len(lines) == 3 and all(map(math.isfinite, out["losses"]))
