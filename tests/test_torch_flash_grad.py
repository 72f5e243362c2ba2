"""The port's flash attention (``repro_torch.models.layers.
flash_attention``, a ``torch.autograd.Function``) against the reference's
``repro.models.layers.flash_attention`` and its ``jax.vjp``, on the CPU,
inputs made from a seed with numpy.

Tolerances, each with its reason:
- float32: outputs and dq, dk, dv within 1e-5 of the reference (the same
  float32 operations summed in another order; at most 1.4e-6 seen on
  gradients up to 7).
- bfloat16: outputs within 2e-2 (one bfloat16 step, as
  ``tests/test_torch_lm.py``'s layers), gradients within 2e-2 absolute
  and relative: the reference's vjp rounds each chunk's dk and dv and
  each chunk's share of dq to bfloat16 where autograd meets its casts,
  the port sums them in float32 and rounds once (one bfloat16 step of
  the gradient, at most 3.1e-2 seen on values up to 7.3).
- The forward against a copy of the loop it replaced (``_loop``, kept
  here as the oracle): bitwise at the default tile (one query block at
  these sizes); with a query block of a few rows, float32 within 2.4e-7
  (a product over fewer rows sums in another order; 1.2e-7 seen) and
  bfloat16 within one bfloat16 step.

The saved-bytes pin counts what autograd keeps for the backward through
``torch.autograd.graph.saved_tensors_hooks``: q, k, v, the output and the
float32 log-sum-exp, plus 5%. The loop it replaced kept each KV chunk's
float32 scores and weights (about 3.4 (B, H, Sq, chunk) tensors a chunk).
"""
import math

import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

import jax
import jax.numpy as jnp

from repro.models import layers as JL

from repro_torch.models import layers as TL

GQA = ((2, 13, 4, 32), (2, 16, 2, 32), (2, 16, 2, 32))
CASES = {
    "default": (GQA, {}),
    "window": (GQA, dict(window=5)),
    "noncausal": (GQA, dict(causal=False)),
    "offset_chunk7": (GQA, dict(q_offset=3, kv_chunk=7)),
    # MLA's prefill: q and k of width hd + 64, v of width hd, one KV head
    # a query head
    "mla_dv": (((2, 13, 3, 48), (2, 16, 3, 48), (2, 16, 3, 32)), {}),
    "rep1": (((2, 13, 4, 32), (2, 16, 4, 32), (2, 16, 4, 32)),
             dict(causal=False)),
    "rep3": (((2, 13, 6, 32), (2, 16, 2, 32), (2, 16, 2, 32)), {}),
    # positions 20-26 see no key of the 16 through the window of 5
    "masked_rows": (GQA, dict(q_offset=14, window=5)),
}
TOL = {"float32": dict(out=1e-5, grad=1e-5),
       "bfloat16": dict(out=2e-2, grad=2e-2)}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(shapes):
    (qs, ks, vs) = shapes
    return (_rand(qs, 9), _rand(ks, 10), _rand(vs, 11),
            _rand(qs[:3] + vs[3:], 12))


def _loop(q, k, v, *, causal=True, window=0, q_offset=0, kv_chunk=1024):
    """The port's flash attention before it became a Function: the online
    softmax over KV chunks that autograd recorded op by op."""
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = H // G
    kv_chunk = min(kv_chunk, Skv)
    dev = q.device
    qf = (q.to(torch.float32) * D ** -0.5).to(q.dtype).to(torch.float32)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Sq), -math.inf, device=dev)
    l = torch.zeros((B, H, Sq), device=dev)
    for c0 in range(0, Skv, kv_chunk):
        k_pos = c0 + torch.arange(kv_chunk, device=dev)
        ki = k[:, c0:c0 + kv_chunk].repeat_interleave(rep, dim=2)
        vi = v[:, c0:c0 + kv_chunk].repeat_interleave(rep, dim=2)
        n = ki.shape[1]
        k_pos = k_pos[:n]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, ki.to(torch.float32))
        mask = torch.ones((Sq, n), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype).to(torch.float32),
            vi.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


@pytest.fixture(scope="module")
def reference():
    """{dtype: {case: (out, dq, dk, dv)}} of the reference's
    ``flash_attention`` and its ``jax.vjp`` for each case's upstream
    gradient, as float32 numpy arrays: every case of a dtype in one jitted
    program, compiled once."""
    def every_case(args):
        res = []
        for (shapes, kw), (q, k, v, g) in zip(CASES.values(), args):
            kw = {"kv_chunk": 8, **kw}
            out, vjp = jax.vjp(
                lambda a, b, c, kw=kw: JL.flash_attention(a, b, c, **kw),
                q, k, v)
            res.append((out, *vjp(g)))
        return res

    ref = {}
    for dtype in TOL:
        jdt = jnp.dtype(dtype)
        args = [tuple(jnp.asarray(a).astype(jdt) for a in _inputs(shapes))
                for shapes, _ in CASES.values()]
        ref[dtype] = {case: [np.asarray(x.astype(jnp.float32)) for x in r]
                      for case, r in zip(CASES, jax.jit(every_case)(args))}
    return ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_reference_vjp(case, dtype, reference):
    """The output and dq, dk, dv against ``jax.vjp`` of the reference for
    the same upstream gradient."""
    shapes, kw = CASES[case]
    kw = {"kv_chunk": 8, **kw}
    q, k, v, g = _inputs(shapes)
    want, *want_grads = reference[dtype][case]
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = TL.flash_attention(*t, **kw)
    out.backward(torch.from_numpy(g).to(tdt))
    tol = TOL[dtype]
    np.testing.assert_allclose(out.detach().float().numpy(), want,
                               atol=tol["out"], rtol=tol["out"])
    for name, x, w in zip("qkv", t, want_grads):
        assert x.grad.dtype == x.dtype
        np.testing.assert_allclose(x.grad.float().numpy(), w,
                                   atol=tol["grad"], rtol=tol["grad"],
                                   err_msg=f"d{name}")
    if case == "masked_rows":
        assert not out[:, 6:].any() and not t[0].grad[:, 6:].any()


@pytest.mark.parametrize("rows", [0, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_holds_to_the_loop(case, dtype, rows, monkeypatch):
    """The forward against the loop it replaced: bitwise at the default
    tile; with query blocks of ``rows`` rows (some blocks' tiles skipped
    whole under the causal mask and the window) within float32 rounding."""
    shapes, kw = CASES[case]
    kw = {"kv_chunk": 8, **kw}
    if rows:
        B, H = shapes[0][0], shapes[0][2]
        monkeypatch.setattr(TL, "TILE_ELEMS", B * H * 8 * rows)
    q, k, v, _ = _inputs(shapes)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got, want = TL.flash_attention(q, k, v, **kw), _loop(q, k, v, **kw)
    if not rows:
        assert torch.equal(got, want)
    else:
        atol = 2.4e-7 if dtype == "float32" else 2 ** -8 * 8
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   atol=atol, rtol=2 ** -8 if
                                   dtype == "bfloat16" else 0)


def test_tiled_gradients_match_one_block(monkeypatch):
    """dq, dk and dv with query blocks of 2 rows against one block: the
    tiles' sums in float32 within float32 rounding."""
    shapes, kw = CASES["window"]
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(shapes))
    grads = []
    for tile in (TL.TILE_ELEMS, 2 * 4 * 8 * 2):
        monkeypatch.setattr(TL, "TILE_ELEMS", tile)
        t = [x.clone().requires_grad_() for x in (q, k, v)]
        TL.flash_attention(*t, kv_chunk=8, **kw).backward(g)
        grads.append([x.grad for x in t])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_saved_bytes_are_inputs_output_and_lse():
    """What autograd keeps for the backward at (B 1, Sq = Skv 1,024, H 8,
    G 2, D 64) with chunks of 256: at most the bytes of q, k, v, the
    output and the float32 log-sum-exp (B, H, Sq), plus 5%."""
    B, S, H, G, D = 1, 1024, 8, 2, 64
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, S, H, D), generator=g).requires_grad_()
    k = torch.randn((B, S, G, D), generator=g).requires_grad_()
    v = torch.randn((B, S, G, D), generator=g).requires_grad_()
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = TL.flash_attention(q, k, v, kv_chunk=256)
    nbytes = lambda t: t.numel() * t.element_size()
    budget = (nbytes(q) + nbytes(k) + nbytes(v) + nbytes(out)
              + B * H * S * 4)
    assert sum(saved) <= 1.05 * budget, (sum(saved), budget, len(saved))
    out.sum().backward()
    assert q.grad.shape == q.shape and torch.isfinite(k.grad).all()
