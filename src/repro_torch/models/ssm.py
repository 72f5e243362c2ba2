"""Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060]: the port
of ``repro.models.ssm``.

Training and prefill use the chunked SSD dual form (quadratic within a
chunk, a linear recurrence across chunks, run as a Python loop over the
chunks); decode is the O(1) recurrent update, which writes the conv and
SSM states in place. ngroups = 1 (B and C shared across heads), as in
the mamba2-780m config. Plain PyTorch, as the reference is jnp: no
Pallas kernel lies on this path.

The dtypes are the reference's: where it asks an einsum for float32
results (``preferred_element_type``) the operands are cast up to
float32 (exact for bfloat16), and the factors it rounds to the model
dtype first (``Lmat``, the decays, the carried states) are rounded the
same way. The SSM state stays float32 in a bfloat16 model.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist import regions as RG
from repro_torch.dist.sharding import constraint, is_dtensor
from repro_torch.models import layers as L

_F32 = torch.float32


def ssm_params(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    """One mixer's parameters, or ``lead`` of them stacked: the projections
    and the conv in the model dtype, ``A_log``, ``D``, ``dt_bias`` and
    ``gate_norm`` in float32."""
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * ns
    dtype = L.dtype_of(cfg)
    dev = gen.device

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=_F32, device=dev)

    conv_w = torch.randn((*lead, cfg.ssm_conv, conv_dim), generator=gen,
                         device=dev) * cfg.ssm_conv ** -0.5
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=_F32, device=dev))
    return {
        "in_proj": L.dense_init(gen, d, 2 * di + 2 * ns + nh, dtype, lead),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=dev),
        "A_log": a_log.expand(*lead, nh).clone(),
        "D": full((nh,), 1.0),
        "dt_bias": full((nh,), 0.0),
        "gate_norm": full((di,), 1.0),
        "out_proj": L.dense_init(gen, di, d, dtype, lead),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., l) -> the lower-triangular pairwise sums (..., l, l):
    cs[i] - cs[j] for j <= i, -inf above the diagonal (masked before any
    exp, so that no inf * 0 reaches the backward). One (..., l, l)
    tensor: the mask is written in place."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    upper = torch.ones((l, l), dtype=torch.bool, device=x.device).triu_(1)
    return seg.masked_fill_(upper, -math.inf)


def _f32(*xs):
    return [x.to(_F32) for x in xs]


def ssd_chunked(x, dtA, B, C, chunk: int, init_state=None):
    """Chunked SSD scan.

    x:   (b, L, h, p), already multiplied by dt
    dtA: (b, L, h), dt * A (negative), float32
    B, C: (b, L, n), shared across heads (ngroups = 1)
    init_state: (b, h, p, n) or None (zeros)
    Returns y (b, L, h, p) in x's dtype and the final state (b, h, p, n)
    in float32. L is padded to whole chunks and y sliced back."""
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
    Ac = dtA.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)    # (b,h,c,l)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    A_cum = torch.cumsum(Ac, dim=-1)                         # (b,h,c,l)
    # (b,h,c,l,l): the exp in place, rounded to the model dtype as the
    # reference rounds it, then its float32 operand (exact); each step
    # replaces the one before, which only autograd may keep
    Lmat = _segsum(Ac).exp_().to(dt)
    Lmat = Lmat.to(_F32)

    # intra-chunk (dual, attention-like) term
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp",
                          *_f32(Cc, Bc, Lmat, xc)).to(dt)
    del Lmat

    # per-chunk final states, float32
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)        # (b,h,c,l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn",
                          *_f32(Bc, decay_states.to(dt), xc))

    # inter-chunk recurrence s_{c+1} = s_c * exp(sum dtA_c) + states_c,
    # keeping the state before each chunk
    chunk_decay = torch.exp(A_cum[..., -1])                  # (b,h,c)
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=_F32, device=x.device)
    st, prev = init_state, []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,c,h,p,n)

    # inter-chunk contribution
    state_decay = torch.exp(A_cum)                           # (b,h,c,l)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp",
                         *_f32(Cc, prev_states.to(dt),
                               state_decay.to(dt))).to(dt)

    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)
    return y[:, :L], st


def _causal_conv(xBC, w, bias, state=None):
    """Depthwise causal conv of width K = w.shape[0], the sum over the K
    shifts in order. xBC: (b, L, ch); w: (K, ch); state: (b, K-1, ch) left
    context (decode) or None (zeros). Returns (out, the new (b, K-1, ch)
    state: a copy of the last K-1 rows of the context and xBC, not a view
    that keeps them all alive)."""
    K = w.shape[0]
    if state is None:
        state = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[-1]))
    xp = torch.cat([state, xBC], dim=1)
    Ln = xBC.shape[1]
    out = xp[:, 0:Ln] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + Ln] * w[i]
    return out + bias, xp[:, -(K - 1):].clone()


def _gated_norm(p, y, z, dtype):
    """Mamba2's gated RMSNorm (eps 1e-5) in float32, cast to ``dtype``."""
    y = y * F.silu(z)
    yf = y.to(_F32)
    return (yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-5)
            * p["gate_norm"]).to(dtype)


def _split_in(p, cfg, x, conv_state):
    """in_proj, the conv and its activation -> (z, xs, B, C, dt raw, the
    new conv state). One conv over all channels, but on a mesh over a
    sequence: there the conv, being depthwise, takes x's, B's and C's
    channels apart, with the same values, x's split over the model axis
    by heads as the scan takes them and B's and C's whole, so that no
    device holds its full width. (Three convs would add a third to a
    decode step's launches on one card, and gather more in a mesh's
    decode step: PERF.md.)"""
    di, ns = cfg.d_inner, cfg.ssm_state
    z, xBC, dt = torch.split(x @ p["in_proj"],
                             [di, di + 2 * ns, cfg.ssm_nheads], dim=-1)
    if not (is_dtensor(x) and x.shape[1] > 1):
        xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                     conv_state)
        xs, B, C = torch.split(F.silu(xBC), [di, ns, ns], dim=-1)
        return z, xs, B, C, dt, new_conv
    outs, tails = [], []
    for lo, hi, axis in ((0, di, "model"), (di, di + ns, None),
                         (di + ns, di + 2 * ns, None)):
        out, tail = _causal_conv(
            constraint(xBC[..., lo:hi], ("batch", None, axis)),
            p["conv_w"][:, lo:hi], p["conv_b"][lo:hi],
            None if conv_state is None else conv_state[..., lo:hi])
        outs.append(F.silu(out))
        tails.append(tail)
    return (z, *outs, dt, torch.cat(tails, dim=-1))


def apply_ssm(p: dict, cfg, x: torch.Tensor, *, conv_state=None,
              ssm_state=None, return_state: bool = False):
    """The Mamba2 mixer on a sequence x: (b, L, d) -> (b, L, d); with
    ``return_state`` also (the new conv state, the final SSM state)."""
    b, Ln, _ = x.shape
    di, nh, hp = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    z, xs, B, C, dt, new_conv = _split_in(p, cfg, x, conv_state)
    dt = F.softplus(dt.to(_F32) + p["dt_bias"])              # (b,L,nh)
    A = -torch.exp(p["A_log"])                               # (nh,)
    xh = xs.reshape(b, Ln, nh, hp)
    xh = constraint(xh, ("batch", None, "ssm_heads", None))
    x_dt = (xh.to(_F32) * dt[..., None]).to(x.dtype)
    scan = (ssd_chunked if not is_dtensor(x_dt) else
            lambda *a, **kw: RG.ssd(ssd_chunked, *a, kw["init_state"]))
    y, final_state = scan(x_dt, dt * A, B, C, cfg.ssm_chunk,
                          init_state=ssm_state)
    y = y + xh * p["D"][None, None, :, None].to(x.dtype)
    y = _gated_norm(p, y.reshape(b, Ln, di), z, x.dtype)
    out = y @ p["out_proj"]
    if return_state:
        return out, (new_conv, final_state)
    return out


def ssm_decode_step(p: dict, cfg, x: torch.Tensor, conv_state: torch.Tensor,
                    ssm_state: torch.Tensor) -> torch.Tensor:
    """One token's recurrent update. x: (b, 1, d) -> (b, 1, d). Writes the
    new conv state into ``conv_state`` (b, K-1, ch) and the new float32
    SSM state into ``ssm_state`` (b, nh, hp, n), in place."""
    b = x.shape[0]
    di, nh, hp = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    z, xs, B, C, dt, new_conv = _split_in(p, cfg, x, conv_state)
    dt = F.softplus(dt[:, 0].to(_F32) + p["dt_bias"])        # (b,nh)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))           # (b,nh)
    xh = xs[:, 0].reshape(b, nh, hp).to(_F32)
    dBx = torch.einsum("bn,bhp,bh->bhpn", B[:, 0].to(_F32), xh, dt)
    new_state = ssm_state * decay[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", new_state, C[:, 0].to(_F32))
    y = y + xh * p["D"][None, :, None]
    y = _gated_norm(p, y.reshape(b, di).to(x.dtype), z[:, 0], x.dtype)
    conv_state.copy_(new_conv)
    ssm_state.copy_(new_state)
    return (y @ p["out_proj"])[:, None, :]
