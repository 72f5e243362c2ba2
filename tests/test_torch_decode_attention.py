"""The port's ``decode_attention`` against the JAX package's.

On the CPU ``repro_torch.kernels.ops.decode_attention`` runs the kernel's
plain version; it is held against the Pallas kernel (interpret mode,
through ``repro.kernels.ops.decode_attention``) at the shapes of
``tests/test_kernels.py``'s sweep, with cache_len at 0, 1, S - 13 and S,
on inputs made from a seed with numpy. Tolerances: rtol float32 2e-5
(both sum float32 products, in another order); bfloat16 2e-2, the
sweep's own (both compute in float32 from the same bfloat16 inputs, so
outputs differ by at most one bfloat16 step, 2^-8 of |o|); atol the
same times min(1, max |o|), since a softmax average over n positions of
N(0, 1) values is only about n^-1/2 in size. Against the JAX model
layer, which rounds q * scale and the softmax weights to the cache dtype
before its products, float32 agrees to 1e-5 and bfloat16 to 1e-2 (about
1e-3 seen).

The kernel cuts the cache into splits and combines them in split order;
``decode_attention_split_plain`` is that arithmetic in PyTorch, held here
against the same references with 1, 2, 3 and 7 splits (empty ones
included), at the same tolerances, and ``choose_splits``, the host's cut,
is held to covering every position once and to the tile the card's
times chose at internlm2's shapes.

The tests marked ``cuda`` hold the CUDA kernel against its plain version
on the card, and run the smoke serve (head dim 32) there, and skip where
there is none. They need no JAX, so the file
also runs on a machine with a card and no JAX (the comparisons with the
JAX package then skip).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.models import layers as JL
except ImportError:
    jnp = None

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops

# the reference sweep of tests/test_kernels.py, then head dim 32 at the
# smoke configurations' H 4, G 2
SWEEP = [(8, 8, 64, 512), (8, 2, 64, 700), (16, 1, 128, 1024),
         (4, 4, 256, 512), (4, 2, 32, 400)]
DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("needs JAX, the reference")


def _inputs(B, H, G, D, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, D)).astype(np.float32),
            rng.standard_normal((B, S, G, D)).astype(np.float32),
            rng.standard_normal((B, S, G, D)).astype(np.float32))


def _both(arrays, dtype):
    return ([jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays],
            [torch.from_numpy(a).to(DTYPES[dtype][0]) for a in arrays])


def _atol(want, tol):
    """tol scaled to the largest output, never above tol (see above)."""
    return tol * min(1.0, float(np.abs(want).max()))


def _f32(x):
    if torch.is_tensor(x):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("H,G,D,S", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_matches_pallas_kernel(jax_ref, H, G, D, S, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, H, G, D, S, H * S), dtype)
    tol = DTYPES[dtype][1]
    for clen in (0, 1, S - 13, S):
        want = jops.decode_attention(jq, jk, jv, clen)
        got = ops.decode_attention(tq, tk, tv, clen)
        assert got.dtype == tq.dtype and got.shape == (2, H, D)
        want = _f32(want)
        np.testing.assert_allclose(_f32(got), want, atol=_atol(want, tol),
                                   rtol=tol, err_msg=f"cache_len={clen}")
        if clen == 0:
            assert not got.any()                # zeros, not NaN


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("clen", [400, 512])
def test_matches_model_layer(jax_ref, dtype, tol, clen):
    """Against ``repro.models.layers.decode_attention`` (B 2, H 8, G 4,
    D 64, S 512), as tests/test_kernels.py holds the Pallas kernel."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 8, 4, 64, 512, 7), dtype)
    want = JL.decode_attention(jq, jk, jv, clen)
    got = ops.decode_attention(tq, tk, tv, clen)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


SPLITS = [1, 2, 3, 7]


def _clens(S, D, itemsize):
    """0, 1, S - 13, S, and a cache_len past one tile but short of a
    third, so that 7 splits of one tile leave empty ones."""
    return (0, 1, S - 13, S, min(S, DA.tile_positions(D, itemsize) + 5))


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("H,G,D,S", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_plain_matches_pallas_kernel(jax_ref, H, G, D, S, dtype,
                                           splits):
    """The kernel's split-and-combine against the Pallas kernel and the
    plain version, empty splits included."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, H, G, D, S, H * S), dtype)
    tol = DTYPES[dtype][1]
    for clen in _clens(S, D, tq.element_size()):
        got = DA.decode_attention_split_plain(tq, tk, tv, clen, splits)
        assert got.dtype == tq.dtype and got.shape == (2, H, D)
        for want in (_f32(jops.decode_attention(jq, jk, jv, clen)),
                     _f32(DA.decode_attention_plain(tq, tk, tv, clen))):
            np.testing.assert_allclose(_f32(got), want, rtol=tol,
                                       atol=_atol(want, tol),
                                       err_msg=f"cache_len={clen}")
        if clen == 0:
            assert not got.any()


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
def test_split_plain_matches_model_layer(jax_ref, dtype, tol, splits):
    """Against ``repro.models.layers.decode_attention`` at the tolerances
    of :func:`test_matches_model_layer`."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 8, 4, 64, 512, 7), dtype)
    for clen in (400, 512):
        want = JL.decode_attention(jq, jk, jv, clen)
        got = DA.decode_attention_split_plain(tq, tk, tv, clen, splits)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("D,itemsize", [(64, 2), (128, 2), (256, 4),
                                        (32, 2), (32, 4)])
def test_choose_splits_cuts_every_position_once(D, itemsize):
    """Every valid position lies in exactly one split, there is at least
    one split, none is empty, and only the last is shorter than a tile;
    the blocks stay within one wave of the card once there are two or
    more splits."""
    large = DA.tile_positions(D, itemsize, DA.LARGE_TILE)
    for blocks in (1, 2, 16, 64, 128, 300):
        for n in (0, 1, large - 1, large, large + 1, 1000, 4099, 32_768):
            tile_bytes, splits, chunk = DA.choose_splits(blocks, n, D,
                                                         itemsize, 132)
            tile = DA.tile_positions(D, itemsize, tile_bytes)
            assert splits >= 1 and chunk % tile == 0 and chunk >= tile
            ranges = [(s * chunk, min(n, (s + 1) * chunk))
                      for s in range(splits)]
            covered = [p for lo, hi in ranges for p in range(lo, hi)]
            assert covered == list(range(n))
            assert all(hi > lo for lo, hi in ranges) or n == 0
            assert all(hi - lo >= tile for lo, hi in ranges[:-1])
            if splits > 1:
                assert blocks * splits <= 132 * DA.BLOCKS_PER_SM[tile_bytes]


@pytest.mark.parametrize("blocks,n,want", [
    (64, 32_768, (DA.LARGE_TILE, 2, 16_512)),   # internlm2 at 32K
    (64, 160, (DA.LARGE_TILE, 1, 192)),         # the serve cache
    (2, 1024, (DA.SMALL_TILE, 11, 96)),         # G = 1 at B 2
])
def test_choose_splits_takes_the_tile_that_won_on_the_card(blocks, n, want):
    """bfloat16 at D 128: the large tile where its blocks fill the SMs or
    one tile holds the cache, the small one for a short cache with few
    (batch row, kv group) pairs, as the H100's times chose (PERF.md)."""
    assert DA.choose_splits(blocks, n, 128, 2, 132) == want


def test_choose_splits_keeps_the_tile_inside_shared_memory():
    """The large tile's float32 scores grow with its positions: at D 32 in
    bfloat16 (768 positions) they overflow a block's shared memory past 8
    query rows, so the host takes the small tile there, whatever the
    cache; every other head dim and dtype fits both tiles at any rep."""
    for D in DA.HEAD_DIMS:
        for itemsize in (2, 4):
            for rep in (1, 2, 3, 4, 8, 9, 16):
                fits = all(DA.smem_bytes(D, itemsize, rep, t) <= DA.SMEM_LIMIT
                           for t in (DA.SMALL_TILE, DA.LARGE_TILE))
                assert fits == (D != 32 or itemsize != 2 or rep <= 8)
                assert DA.smem_bytes(D, itemsize, rep,
                                     DA.SMALL_TILE) <= DA.SMEM_LIMIT
    for n in (1, 160, 32_768):
        assert DA.choose_splits(64, n, 32, 2, 132, 16)[0] == DA.SMALL_TILE
    assert DA.choose_splits(64, 32_768, 32, 2, 132, 8)[0] == DA.LARGE_TILE


def test_split_chunk_leaves_empty_splits_past_a_short_cache():
    """With more splits than tiles, the splits past the cache are empty,
    and the split-and-combine still equals the plain version."""
    assert DA.split_chunk(1, 7, 96) == 96
    assert DA.split_chunk(200, 7, 96) == 96      # 3 of 7 hold positions
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 2, 128, 300, 5))
    for clen in (1, 200):
        torch.testing.assert_close(
            DA.decode_attention_split_plain(q, k, v, clen, 7),
            DA.decode_attention_plain(q, k, v, clen), rtol=2e-5, atol=2e-5)


def test_ignores_what_lies_past_cache_len():
    """Positions >= cache_len are never read: NaN there changes nothing."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 64, 40, 3))
    torch.testing.assert_close(ops.decode_attention(q, k, v, 10 ** 6),
                               ops.decode_attention(q, k, v, 40),
                               rtol=0, atol=0)
    want = ops.decode_attention(q, k, v, 25)
    k[:, 25:], v[:, 25:] = float("nan"), float("inf")
    torch.testing.assert_close(ops.decode_attention(q, k, v, 25), want,
                               rtol=0, atol=0)


def test_kernel_launcher_refuses_what_it_cannot_take():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 64, 8, 0))
    with pytest.raises(ValueError, match="CUDA"):
        DA.decode_attention(q, k, v, 4)
    for bad in ((q[:, :3], k, v), (q[..., :48], k[..., :48], v[..., :48]),
                (q.double(), k.double(), v.double()), (q, k, v[:, :4])):
        with pytest.raises(ValueError):
            DA.decode_attention(*bad, 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H,G,D,S", SWEEP + [(16, 8, 128, 4099),
                                             (12, 4, 64, 77),
                                             (16, 1, 64, 300),
                                             (16, 8, 128, 8192),
                                             (16, 1, 32, 1000),
                                             (8, 8, 32, 4099)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_matches_plain(cuda, H, G, D, S, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda, DTYPES[dtype][0])
               for a in _inputs(3, H, G, D, S, S))
    tol = DTYPES[dtype][1]
    for clen in (0, 1, S - 13, S):
        before = build.LAUNCHES["decode_attention"]
        got = DA.decode_attention(q, k, v, clen)
        assert build.LAUNCHES["decode_attention"] == before + 1
        want = DA.decode_attention_plain(q, k, v, clen)
        torch.testing.assert_close(
            got.float(), want.float(), rtol=tol,
            atol=_atol(want.float().cpu().numpy(), tol))
        assert torch.equal(got, DA.decode_attention(q, k, v, clen))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_splits_match_split_plain(cuda, dtype, splits):
    """The kernel with a given number of splits, empty ones included,
    against its split-and-combine in PyTorch and the plain version; one
    launch a call, bitwise repeatable."""
    H, G, D, S = 16, 8, 128, 1024
    q, k, v = (torch.from_numpy(a).to(cuda, DTYPES[dtype][0])
               for a in _inputs(2, H, G, D, S, splits))
    tol = DTYPES[dtype][1]
    for clen in _clens(S, D, q.element_size()):
        before = build.LAUNCHES["decode_attention"]
        got = DA._decode_attention_splits(q, k, v, clen, splits)
        assert build.LAUNCHES["decode_attention"] == before + 1
        for want in (DA.decode_attention_split_plain(q, k, v, clen, splits),
                     DA.decode_attention_plain(q, k, v, clen)):
            torch.testing.assert_close(
                got.float(), want.float(), rtol=tol,
                atol=_atol(want.float().cpu().numpy(), tol))
        assert torch.equal(got, DA._decode_attention_splits(q, k, v, clen,
                                                            splits))
        if clen == 0:
            assert not got.any()


@pytest.mark.cuda
def test_serve_smoke_runs_on_the_card(cuda):
    """``launch.serve --smoke`` (head dim 32) without ``--device``: the
    card, through the kernel."""
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    assert "generated token ids (first row): " in out.stdout


@pytest.mark.cuda
def test_smoke_generate_on_the_card_equals_the_cpu(cuda):
    """internlm2's smoke config in float32 from the same CPU-drawn
    parameters and prompts: ``generate`` on the card (decode_attention at
    D 32, once per layer per step) gives the CPU's greedy tokens, logits
    within 1e-4 (cuBLAS and the CPU's BLAS sum in other orders)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    cfg = get_smoke_config("internlm2-1.8b").replace(dtype="float32",
                                                     remat=False)
    params = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in tree.items()}

    prompts = torch.randint(0, cfg.vocab_size, (4, 16),
                            generator=torch.Generator().manual_seed(1))
    want = serve.generate(params, cfg, prompts, 8)
    before = build.LAUNCHES["decode_attention"]
    got = serve.generate(to(params), cfg, prompts.to(cuda), 8)
    assert build.LAUNCHES["decode_attention"] == before + cfg.n_layers * 24
    assert got.finite
    np.testing.assert_array_equal(got.tokens.cpu().numpy(),
                                  want.tokens.numpy())
    torch.testing.assert_close(got.logits.cpu(), want.logits, rtol=1e-4,
                               atol=1e-4)
