"""The port's Mamba2 / SSD mixer (``repro_torch.models.ssm``) and
mamba2-780m (48 attention-free Mamba2 layers at full width) against the
JAX package, on the CPU, inputs made from a seed with numpy and both
packages started from the reference's parameters.

The units, at ``tests/test_ssm_math.py``'s shapes (L % chunk != 0 among
them) and the arch's smoke config (d 128, 8 heads of 32, state 16):
- ``ssd_chunked`` in float32 within 1e-5 of the reference's (the same
  float32 products summed in another order) and within 1e-4 of the naive
  recurrence (``test_ssm_math.py``'s tolerance); a run cut in two with the
  state carried by ``init_state`` within 1e-5 of the whole run; in
  bfloat16 (x, B and C bfloat16, dtA float32) within 2e-2 of the
  reference's, one bfloat16 step of the value where the two round a
  float32 product to bfloat16 differently.
- ``ssd_chunked`` bitwise a copy of the parent's scan kept here, outputs
  and every input's gradient, in float32 and bfloat16, and without
  autograd its peak one float32 (l, l) factor below the parent's;
  ``_split_in`` on plain tensors bitwise the parent's one conv over all
  channels, the new conv state now a copy, with one launch more.
- ``_causal_conv`` with and without a state within 1e-6 in float32 (four
  products and adds in the reference's order; XLA may contract a
  multiply and an add into one rounding).
- ``apply_ssm(return_state=True)`` and five ``ssm_decode_step`` updates
  (output, conv state and float32 SSM state, written in place) within
  1e-5 in float32 and 5e-2 in bfloat16: the mixer rounds to bfloat16 at
  a dozen places between its two projections, and the reference's own
  bfloat16 output lies 3.7e-2 from its float32 run on the same inputs
  (the port's 2.8e-2 from the reference's, in |diff| / (1 + |value|)).

The arch's smoke config then goes through ``tests/lm_parity.py``'s checks
in float32 and bfloat16 at the tolerances stated there, but for one:
in float32 a gradient leaf within 3e-5 of its norm (lm_parity: 1e-5).
``A_log``'s gradient (8 entries a layer, each a sum over every position
of terms through the chunk's cumsum differences) carries float32's own
error: against a float64 run of the same model both packages' float32
gradients lie 1.1e-5 (reference) and 1.2e-5 (port) of its norm away;
every other leaf within 5e-6. One ``sync_grads`` call on the smoke tree,
whose ``A_log``, ``D``, ``dt_bias``, ``gate_norm`` and norm scales are
float32 beside bfloat16 projections, equals the reference's synced
values, ages and wire bytes exactly. The config field for field is in
``tests/test_torch_dense_archs.py::test_config_matches_reference``.
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
from repro.models import ssm as JM
from repro.models import transformer as JT
from repro.optim import optimizers as JO

import lm_parity as P
from test_ssm_math import naive_ssd
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch import tree
from repro_torch.configs import get_smoke_config
from repro_torch.dist import sparse_sync as TS
from repro_torch.launch import serve, train
from repro_torch.models import ssm as TM
from repro_torch.models import transformer as TT

ARCH = "mamba2-780m"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MIXER_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
FAMILY_TOL = {"float32": dict(grad_rel=3e-5), "bfloat16": {}}
R, K = 512, 64                  # the sync's budget on the smoke tree


def _cfgs(dtype):
    return (j_smoke_config(ARCH).replace(dtype=dtype),
            get_smoke_config(ARCH).replace(dtype=dtype))


def _params(jcfg):
    jp = JM.ssm_params(jax.random.PRNGKey(3), jcfg)
    return jp, P.carry(jp)


def _x(shape, seed, dtype, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    return (jnp.asarray(a).astype(jnp.dtype(dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _ssd_inputs(b, L, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, L, h, p)).astype(np.float32),
            (-np.abs(rng.standard_normal((b, L, h))) * 0.5).astype(np.float32),
            rng.standard_normal((b, L, n)).astype(np.float32),
            rng.standard_normal((b, L, n)).astype(np.float32))


# ---------------------------------------------------------------------------
# the SSD scan and the conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,chunk", [(8, 4), (16, 4), (12, 5), (7, 16)])
def test_ssd_chunked_matches(L, chunk):
    x, dtA, B, C = _ssd_inputs(2, L, 3, 4, 5, L * chunk)
    y, final = TM.ssd_chunked(*map(torch.from_numpy, (x, dtA, B, C)), chunk)
    jy, jfinal = jax.jit(JM.ssd_chunked, static_argnums=4)(
        *map(jnp.asarray, (x, dtA, B, C)), chunk)
    assert y.shape == (2, L, 3, 4) and final.dtype == torch.float32
    P.close(y, jy, TOL["float32"])
    P.close(final, jfinal, TOL["float32"])
    y_ref, final_ref = naive_ssd(x.astype(np.float64), dtA, B, C)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(final.numpy(), final_ref, atol=1e-4,
                               rtol=1e-4)


def test_ssd_chunked_carries_init_state():
    """The sequence cut in two, the first half's state handed to the
    second as ``init_state``: the second half's y and the final state
    equal the whole run's, and the reference's from the same state."""
    x, dtA, B, C = map(torch.from_numpy, _ssd_inputs(1, 12, 2, 3, 4, 0))
    y, st = TM.ssd_chunked(x, dtA, B, C, 4)
    _, st1 = TM.ssd_chunked(x[:, :5], dtA[:, :5], B[:, :5], C[:, :5], 4)
    y2, st2 = TM.ssd_chunked(x[:, 5:], dtA[:, 5:], B[:, 5:], C[:, 5:], 4,
                             init_state=st1)
    P.close(y2, y[:, 5:], TOL["float32"])
    P.close(st2, st, TOL["float32"])
    jy2, jst2 = JM.ssd_chunked(
        *(jnp.asarray(a[:, 5:].numpy()) for a in (x, dtA, B, C)), 4,
        init_state=jnp.asarray(st1.numpy()))
    P.close(y2, jy2, TOL["float32"])
    P.close(st2, jst2, TOL["float32"])


def test_ssd_chunked_bfloat16():
    """x, B and C in bfloat16, dtA in float32: y in bfloat16, the state in
    float32, both near the reference's."""
    x, dtA, B, C = _ssd_inputs(2, 20, 3, 4, 5, 9)
    bf = [x, B, C]
    jy, jst = JM.ssd_chunked(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dtA),
                             *(jnp.asarray(a, jnp.bfloat16) for a in bf[1:]),
                             8)
    tb = [torch.from_numpy(a).bfloat16() for a in bf]
    y, st = TM.ssd_chunked(tb[0], torch.from_numpy(dtA), tb[1], tb[2], 8)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    P.close(y, jy, TOL["bfloat16"])
    P.close(st, jst, TOL["bfloat16"])


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    jw, tw = _x((4, 24), 1, "float32")
    jb, tb = _x((24,), 2, "float32")
    jx, tx = _x((2, 7, 24), 3, "float32")
    js, ts = _x((2, 3, 24), 4, "float32") if with_state else (None, None)
    out, st = TM._causal_conv(tx, tw, tb, ts)
    jout, jst = JM._causal_conv(jx, jw, jb, js)
    assert out.shape == (2, 7, 24) and st.shape == (2, 3, 24)
    P.close(out, jout, 1e-6)
    P.close(st, jst, 0)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_ssm_matches(dtype):
    """40 positions (a chunk of 32 and a ragged one) from a handed conv
    and SSM state: the output, the new conv state and the final state."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    jx, tx = _x((2, 40, 128), 5, dtype)
    jc, tc = _x((2, 3, tcfg.d_inner + 2 * tcfg.ssm_state), 6, dtype)
    js, ts = _x((2, tcfg.ssm_nheads, tcfg.ssm_headdim, tcfg.ssm_state), 7,
                "float32", 0.1)
    want, (wc, ws) = jax.jit(lambda p, x, c, s: JM.apply_ssm(
        p, jcfg, x, conv_state=c, ssm_state=s, return_state=True))(
        jp, jx, jc, js)
    got, (gc, gs) = TM.apply_ssm(tp, tcfg, tx, conv_state=tc, ssm_state=ts,
                                 return_state=True)
    assert got.dtype == tx.dtype and gs.dtype == torch.float32
    for a, b in ((got, want), (gc, wc), (gs, ws)):
        assert tuple(a.shape) == b.shape
        P.close(a, b, MIXER_TOL[dtype])
    P.close(TM.apply_ssm(tp, tcfg, tx),
            jax.jit(lambda p, x: JM.apply_ssm(p, jcfg, x))(jp, jx),
            MIXER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_step_matches(dtype):
    """Five tokens, one a step: the output, and both states written in
    place (the SSM state float32)."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    ch = tcfg.d_inner + 2 * tcfg.ssm_state
    conv = torch.zeros((2, 3, ch), dtype=getattr(torch, dtype))
    state = torch.zeros((2, tcfg.ssm_nheads, tcfg.ssm_headdim,
                         tcfg.ssm_state))
    jconv = jnp.zeros(conv.shape, jnp.dtype(dtype))
    jstate = jnp.zeros(state.shape, jnp.float32)
    jstep = jax.jit(lambda p, x, c, s: JM.ssm_decode_step(p, jcfg, x, c, s))
    for t in range(5):
        jx, tx = _x((2, 1, 128), 20 + t, dtype)
        want, (jconv, jstate) = jstep(jp, jx, jconv, jstate)
        got = TM.ssm_decode_step(tp, tcfg, tx, conv, state)
        assert got.shape == (2, 1, 128) and got.dtype == tx.dtype
        P.close(got, want, MIXER_TOL[dtype], f"out, step {t}")
        P.close(conv, jconv, MIXER_TOL[dtype], f"conv, step {t}")
        P.close(state, jstate, MIXER_TOL[dtype], f"state, step {t}")
    assert state.dtype == torch.float32 and state.abs().sum() > 0


# ---------------------------------------------------------------------------
# the arch's smoke config through lm_parity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def ref(request):
    return P.reference(ARCH, request.param, FAMILY_TOL[request.param])


def test_params_carry_across_leaf_for_leaf(ref):
    """Mixed leaves: the four float32 vectors of each mixer (and the norm
    scales) beside the bfloat16 projections in a bfloat16 tree."""
    P.check_init_tree(ref)
    ssm = ref["tparams"]["layers"]["ssm"]
    want = torch.float32 if ref["dtype"] == "float32" else torch.bfloat16
    assert all(ssm[k].dtype == torch.float32
               for k in ("A_log", "D", "dt_bias", "gate_norm"))
    assert all(ssm[k].dtype == want
               for k in ("in_proj", "conv_w", "conv_b", "out_proj"))


def test_decode_loop_matches_jax(ref):
    P.check_decode_loop(ref)


def test_generate_matches_jax_greedy(ref):
    P.check_generate(ref)


def test_prefill_matches_jax(ref):
    P.check_prefill(ref)


def test_decode_matches_own_prefill(ref):
    P.check_decode_matches_own_prefill(ref)


def test_loss_fn_matches(ref):
    P.check_loss(ref)


def test_remat_is_bitwise():
    """``cfg.remat`` recomputes each layer in the backward pass: no bit of
    the loss or a gradient changes."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32", remat=False)
    params = TT.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    batch = {k: torch.from_numpy(P.tokens((2, 40), s))
             for k, s in (("tokens", 1), ("labels", 2))}
    outs = [tree.value_and_grad(
        lambda p, b: TT.loss_fn(p, cfg.replace(remat=remat), b)[0], params,
        batch) for remat in (False, True)]
    (l0, g0), (l1, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g0),
                                                 tree.leaves(g1)))


def test_sync_grads_on_ssm_tree(ref):
    """One ``sync_grads`` call on the reference's smoke-config gradient
    (11 buckets, each in its own dtype) against the reference's jitted
    ``make_sync_train_step`` (read through a linear loss and SGD at lr 1
    from zeros, as ``tests/test_torch_sparse_sync.py`` reads it): synced
    values, ages and wire bytes equal."""
    rng = np.random.default_rng(0)
    batch = {k: jnp.asarray(rng.integers(0, 512, (2, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    jcfg = ref["jcfg"]
    jg = jax.jit(jax.grad(lambda p, b: JT.loss_fn(p, jcfg, b)[0]))(
        ref["jparams"], batch)
    tg = P.carry(jg)
    assert len(tree.leaves(tg)) == 11
    method = "rage_k"
    kw = dict(method=method, r=R, k=K, candidates="threshold")
    opt = JO.sgd(1.0)
    step = jax.jit(JS.make_sync_train_step(
        lambda p, b: sum(jnp.sum(a * c) for a, c in zip(
            jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(b))),
        opt, None, **kw))
    p0 = jax.tree_util.tree_map(jnp.zeros_like, jg)
    p1, _, jages, _, jst = step(p0, opt.init(p0),
                                JS.init_age_state(jg, method=method), jg)
    tsyn, tages, tst = TS.sync_grads(tg, TS.init_age_state(tg,
                                                           method=method),
                                     **kw)
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


# ---------------------------------------------------------------------------
# the scan's memory: bitwise the parent's scan, fewer (l, l) temporaries
# ---------------------------------------------------------------------------


def _ssd_chunked_parent(x, dtA, B, C, chunk: int, init_state=None):
    """``ssd_chunked`` as it was before its (l, l) temporaries were cut:
    ``_segsum``'s difference, ``where`` and ``exp`` each a tensor, and the
    float32 ``Lmat``, its model-dtype rounding and that rounding's float32
    copy all live at the intra-chunk product."""
    import torch.nn.functional as F

    def segsum(a):
        l = a.shape[-1]
        cs = torch.cumsum(a, dim=-1)
        seg = cs[..., :, None] - cs[..., None, :]
        mask = torch.tril(torch.ones((l, l), dtype=torch.bool))
        return torch.where(mask, seg, -math.inf)

    def f32(*xs):
        return [t.to(torch.float32) for t in xs]

    b, L, h, p = x.shape
    n = B.shape[-1]
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtA = F.pad(dtA, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (L + pad) // chunk
    dt = x.dtype
    xc = x.reshape(b, nc, chunk, h, p)
    Ac = dtA.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    A_cum = torch.cumsum(Ac, dim=-1)
    Lmat = torch.exp(segsum(Ac))
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp",
                          *f32(Cc, Bc, Lmat.to(dt), xc)).to(dt)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn",
                          *f32(Bc, decay_states.to(dt), xc))
    chunk_decay = torch.exp(A_cum[..., -1])
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=torch.float32)
    st, prev = init_state, []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)
    state_decay = torch.exp(A_cum)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp",
                         *f32(Cc, prev_states.to(dt),
                              state_decay.to(dt))).to(dt)
    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)
    return y[:, :L], st


def _smoke_scan_inputs(dtype, L=100):
    """The smoke config's scan shapes (8 heads of 32, state 16, chunk 32),
    L padded to whole chunks, with an initial state; x, B and C in
    ``dtype``, dtA and the state float32."""
    cfg = get_smoke_config(ARCH)
    h, p, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    x, dtA, B, C = _ssd_inputs(2, L, h, p, n, 11)
    s0 = np.random.default_rng(12).standard_normal((2, h, p, n))
    dt = getattr(torch, dtype)
    return ([torch.from_numpy(x).to(dt), torch.from_numpy(dtA),
             torch.from_numpy(B).to(dt), torch.from_numpy(C).to(dt),
             torch.from_numpy(s0.astype(np.float32))], cfg.ssm_chunk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_is_bitwise_the_parent_scan(dtype):
    """Outputs and the gradients of every input, bitwise the parent's."""
    ins, chunk = _smoke_scan_inputs(dtype)
    g = torch.Generator().manual_seed(5)
    outs = {}
    for name, fn in (("now", TM.ssd_chunked), ("parent", _ssd_chunked_parent)):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        y, st = fn(*leaves[:4], chunk, init_state=leaves[4])
        if name == "now":
            gy = torch.randn(y.shape, generator=g).to(y.dtype)
            gs = torch.randn(st.shape, generator=g)
        grads = torch.autograd.grad((y, st), leaves, (gy, gs))
        outs[name] = [y, st, *grads]
    for a, b in zip(outs["now"], outs["parent"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_ssd_chunked_peak_holds_one_lmat():
    """Without autograd the intra-chunk product's peak holds one float32
    (b, h, c, l, l) factor where the parent's held the exp's, its
    rounding's float32 copy and the einsum's own: at (1, 256) x 4 heads,
    chunk 64 (each factor 256 KiB), at least one factor less, and the same
    values."""
    from torch.distributed._tools.mem_tracker import MemTracker

    ins, _ = _smoke_scan_inputs("bfloat16", L=256)
    x, dtA, B, C, _ = ins
    x, dtA = x[:1, :, :4], dtA[:1, :, :4]
    B, C = B[:1].contiguous(), C[:1].contiguous()
    x, dtA = x.contiguous(), dtA.contiguous()
    lmat_bytes = 1 * 4 * 4 * 64 * 64 * 4
    peaks, ys = {}, {}
    for name, fn in (("now", TM.ssd_chunked), ("parent", _ssd_chunked_parent)):
        mt = MemTracker()
        with torch.no_grad(), mt:
            ys[name] = fn(x, dtA, B, C, 64)
        peaks[name] = max(v["Total"] for v in
                          mt.get_tracker_snapshot("peak").values())
    assert torch.equal(ys["now"][0], ys["parent"][0])
    assert torch.equal(ys["now"][1], ys["parent"][1])
    assert peaks["now"] <= peaks["parent"] - lmat_bytes, peaks


def _split_in_joint(p, cfg, x, conv_state):
    """``_split_in`` as it was before the conv went by channel group: one
    conv over all of x's, B's and C's channels, then the split."""
    import torch.nn.functional as F

    di, ns = cfg.d_inner, cfg.ssm_state
    z, xBC, dt = torch.split(x @ p["in_proj"],
                             [di, di + 2 * ns, cfg.ssm_nheads], dim=-1)
    xBC, new_conv = TM._causal_conv(xBC, p["conv_w"], p["conv_b"],
                                    conv_state)
    xs, B, C = torch.split(F.silu(xBC), [di, ns, ns], dim=-1)
    return z, xs, B, C, dt, new_conv


class _OpCount(TorchDispatchMode):
    """The aten ops dispatched in its extent that are no views: a kernel
    launch each on the card."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ret = func._schema.returns
        self.n += not (ret and ret[0].alias_info is not None)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("with_state", [False, True])
def test_split_in_is_bitwise_the_joint_conv(with_state):
    """The in-projection and the conv on plain tensors (one card): bitwise
    the parent's one conv over all channels, the new conv state too (now
    a copy), over a sequence and one token (decode), with one aten op
    more than the parent's (the copy): a decode step is host-bound on the
    card, and three convs, as a mesh runs them, would add a third to its
    launches."""
    cfg = get_smoke_config(ARCH).replace(dtype="bfloat16")
    params = TM.ssm_params(torch.Generator().manual_seed(4), cfg)
    rng = np.random.default_rng(6)
    ch = cfg.d_inner + 2 * cfg.ssm_state
    conv = (torch.from_numpy(rng.standard_normal(
        (2, cfg.ssm_conv - 1, ch)).astype(np.float32)).to(torch.bfloat16)
        if with_state else None)
    for L in (40, 1):
        x = torch.from_numpy(rng.standard_normal(
            (2, L, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
        with _OpCount() as ops_joint:
            joint = _split_in_joint(params, cfg, x, conv)
        with _OpCount() as ops_now:
            now = TM._split_in(params, cfg, x, conv)
        for a, b in zip(now, joint):
            assert a.shape == b.shape and torch.equal(a, b)
        assert ops_now.n <= ops_joint.n + 1, (ops_now.n, ops_joint.n)
