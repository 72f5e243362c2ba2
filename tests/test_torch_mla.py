"""The port's Multi-head Latent Attention (``repro_torch.models.mla``) and
deepseek-v2-236b (MLA attention over a 160-expert MoE with 2 shared
experts at full width) against the JAX package, on the CPU.

The units run on deepseek-v2-236b's smoke config (d 256, H 4, head dim
64, latent rank 64), with parameters the reference draws and inputs made
from a seed with numpy: ``mla_prefill`` (the output and both latent
caches, the KV chunks cutting the sequence) and ``mla_decode`` over
positions 0-6 of an 8-slot cache (the output and both caches each
step). Float32 within 1e-5 (the same float32 operations summed in
another order); bfloat16 within 2e-2 (one bfloat16 step, 2^-8 of the
value, where the two round a float32 result differently). The arch's
smoke config then goes through ``tests/lm_parity.py``'s checks in
float32 and bfloat16, at the tolerances stated there.
"""
import dataclasses

import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke_config
from repro.models import mla as JM

import lm_parity as P
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve, train
from repro_torch.models import mla as TM
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_model

ARCH = "deepseek-v2-236b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(dtype):
    return (j_smoke_config(ARCH).replace(dtype=dtype),
            get_smoke_config(ARCH).replace(dtype=dtype))


def _params(jcfg):
    jp = JM.mla_params(jax.random.PRNGKey(3), jcfg)
    return jp, P.carry(jp)


def _x(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a).astype(jnp.dtype(dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    jx, tx = _x((2, 13, 256), 4, dtype)
    pos = np.arange(13)
    want, (wc, wr) = JM.mla_prefill(jp, jcfg, jx, jnp.asarray(pos),
                                    kv_chunk=5)
    got, (gc, gr) = TM.mla_prefill(tp, tcfg, tx, torch.from_numpy(pos),
                                   kv_chunk=5)
    assert got.dtype == tx.dtype and tuple(gc.shape) == wc.shape == \
        (2, 13, 64) and tuple(gr.shape) == wr.shape == (2, 13, 64)
    for a, b in ((got, want), (gc, wc), (gr, wr)):
        P.close(a, b, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches(dtype):
    """Positions 0-6 of an 8-slot cache, one token a step: the output and
    both caches, written in place, each step."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jcache = {"c_kv": jnp.zeros((2, 8, 64), jdt),
              "k_rope": jnp.zeros((2, 8, 64), jdt)}
    c_kv = torch.zeros((2, 8, 64), dtype=tdt)
    k_rope = torch.zeros((2, 8, 64), dtype=tdt)
    for pos in range(7):
        jx, tx = _x((2, 1, 256), 10 + pos, dtype)
        want, jcache = JM.mla_decode(jp, jcfg, jx, jcache, pos)
        got = TM.mla_decode(tp, tcfg, tx, c_kv, k_rope, pos)
        assert got.shape == (2, 1, 256) and got.dtype == tdt
        P.close(got, want, TOL[dtype], f"out, position {pos}")
        P.close(c_kv, jcache["c_kv"], TOL[dtype], f"c_kv, position {pos}")
        P.close(k_rope, jcache["k_rope"], TOL[dtype],
                f"k_rope, position {pos}")
    assert not c_kv[:, 7].any()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def ref(request):
    return P.reference(ARCH, request.param)


def test_params_carry_across_leaf_for_leaf(ref):
    P.check_init_tree(ref)


def test_decode_loop_matches_jax(ref):
    P.check_decode_loop(ref)


def test_generate_matches_jax_greedy(ref):
    P.check_generate(ref)


def test_prefill_matches_jax(ref):
    P.check_prefill(ref)


def test_decode_matches_own_prefill(ref):
    P.check_decode_matches_own_prefill(ref)


def test_loss_fn_matches(ref):
    """Including ``lb_loss``'s path through the router (0.01 of it in the
    loss) and the shared expert's MLP."""
    P.check_loss(ref)


def test_latent_cache_layout():
    """``init_cache`` under MLA: c_kv (L, B, max_len, rank) and k_rope
    (L, B, max_len, 64), no K/V, in the model dtype, with no sliding
    window cut (as the reference's)."""
    cfg = get_smoke_config(ARCH).replace(sliding_window=4)
    cache = TT.init_cache(cfg, 3, 10, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "c_kv": (2, 3, 10, 64), "k_rope": (2, 3, 10, TM.ROPE_DIM)}
    assert all(v.dtype == torch.bfloat16 and not v.any()
               for v in cache.values())


def test_config_matches_reference():
    for mine, theirs in ((get_config, j_config),
                         (get_smoke_config, j_smoke_config)):
        assert (dataclasses.asdict(mine(ARCH))
                == dataclasses.asdict(theirs(ARCH)))
        assert mine(ARCH).param_count() == theirs(ARCH).param_count()
    assert get_config(ARCH).param_count() == 241_127_874_560
    assert get_model(get_config(ARCH)).init_cache is TT.init_cache


def test_serve_and_train_cli_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "8", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"arch={ARCH} batch=2 prefill=")
    assert lines[1].startswith("generated token ids (first row): ")
    out = train.main(["--arch", ARCH, "--smoke", "--steps", "2",
                      "--log-every", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"arch={ARCH} params=")
    assert len(lines) == 3 and all(np.isfinite(out["losses"]))
