"""The port's VLM family and pixtral-12b (the dense GQA stack, 40 layers, 32
heads of 128 over 8 kv heads, fed embeddings where the other families
take tokens; its vision encoder is a stub in the reference too) against
the JAX package, on the CPU, inputs made from a seed with numpy and both
packages started from the reference's parameters.

The arch's smoke config goes through ``tests/lm_parity.py``'s checks in
float32 and bfloat16 at lm_parity's tolerances: the init tree; the loss
and every gradient from ``embeds`` batches; prefill over embeddings; the
decode loop from tokens (the reference's serve CLI serves the VLM from
tokens) and from ``embed`` inputs at every step; the greedy serve loop;
decode == prefill over the same embeddings. One ``sync_grads`` call on
the bfloat16 smoke tree equals the reference's synced values, ages and
wire bytes exactly. pixtral's full-width decode shape (rep 4, D 128)
runs through ``tests/test_torch_decode_attention.py``'s sweep.
"""
import dataclasses
import json

import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke_config

import lm_parity as P
from repro_torch import tree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve, train
from repro_torch.models import transformer as TT

ARCH = "pixtral-12b"
R, K = 512, 64                  # the sync's budget on the smoke tree
TRAIN_LAYERS = 4                # the card's training cut (chip_smoke.py)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def ref(request):
    return P.reference(ARCH, request.param)


def test_params_carry_across_leaf_for_leaf(ref):
    """The dense block stack, tied (no ``lm_head``), no QKV bias."""
    P.check_init_tree(ref)
    params = ref["tparams"]
    assert set(params) == {"embed", "layers", "norm_f"}
    assert set(params["layers"]) == {"attn", "ln1", "ln2", "mlp"}


def test_decode_loop_from_tokens_matches_jax(ref):
    P.check_decode_loop(ref)


def test_decode_loop_from_embeds_matches_jax(ref):
    """Every step fed an ``embed`` (B, d) in place of a token."""
    run = ref["embed_run"]
    P.check_feed_loop(ref, run["feeds"], run["steps"],
                      TT.init_cache(ref["tcfg"], P.B, P.P + P.GEN,
                                    device="cpu"))


def test_generate_matches_jax_greedy(ref):
    P.check_generate(ref)


def test_prefill_matches_jax(ref):
    assert set(ref["pre_in"]) == {"embeds"}
    P.check_prefill(ref)


def test_decode_matches_own_prefill(ref):
    P.check_decode_matches_own_prefill(ref)


def test_loss_fn_matches(ref):
    assert set(ref["batch"]) == {"embeds", "labels"}
    P.check_loss(ref)


@pytest.mark.parametrize("arch", [ARCH, "internlm2-1.8b"])
def test_decode_takes_the_embed_where_present(arch):
    """In any family an ``embed`` input is taken and a token beside it is
    not read, as in the reference's ``decode_step``."""
    cfg = get_smoke_config(arch).replace(dtype="float32", remat=False)
    params = TT.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    emb = torch.randn((2, cfg.d_model), generator=torch.Generator()
                      .manual_seed(4))
    outs = []
    for inputs in ({"embed": emb}, {"embed": emb,
                                    "token": torch.tensor([1, 2])}):
        cache = TT.init_cache(cfg, 2, 4, device="cpu")
        outs.append(TT.decode_step(params, cfg, inputs, cache, 0))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(outs[0][1][k], outs[1][1][k]) for k in outs[0][1])
    tok = TT.decode_step(params, cfg, {"token": torch.tensor([1, 2])},
                         TT.init_cache(cfg, 2, 4, device="cpu"), 0)[0]
    assert not torch.equal(tok, outs[0][0])


def test_full_width_config_cache_and_training_cut():
    """pixtral-12b at full width: every config field the reference's;
    11,576,688,640 parameters by ``param_count`` (tied embeddings); the
    serve cache's shapes; the stacked ``mlp.w1`` past 2^31 elements at
    full depth (the kernels' and the wire's int32 indices), so training on
    the card is cut to ``TRAIN_LAYERS`` layers (1,761,648,640
    parameters)."""
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(j_smoke_config(ARCH))
    assert cfg.param_count() == 11_576_688_640 and cfg.tie_embeddings
    cache = TT.init_cache(cfg, 8, 160, device="meta")
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "k": ((40, 8, 160, 8, 128), torch.bfloat16),
        "v": ((40, 8, 160, 8, 128), torch.bfloat16)}
    assert cfg.n_layers * cfg.d_model * cfg.d_ff == 2_936_012_800 > 2 ** 31
    cut = cfg.replace(n_layers=TRAIN_LAYERS)
    assert cut.param_count() == 1_761_648_640
    assert TRAIN_LAYERS * cfg.d_model * cfg.d_ff < 2 ** 31


def test_sync_grads_on_vlm_tree():
    tg = P.check_sync_grads(ARCH, R, K)
    assert len(tree.leaves(tg)) == 11


def test_serve_cli_serves_and_train_cli_refuses(capsys):
    """``launch.serve --smoke`` serves the VLM from tokens on the CPU, as
    the reference's CLI does; ``launch.train`` refuses it (ROADMAP queue
    3, fault 9: the token stream makes no ``embeds``)."""
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"arch={ARCH} batch=2 prefill=")
    assert lines[1].startswith("generated token ids (first row): ")
    assert len(json.loads(lines[1].split(": ")[1])) == 4
    with pytest.raises(ValueError, match="fault 9"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
