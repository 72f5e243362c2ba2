"""The port's other dense configs against the JAX package: gemma-2b (MQA,
GeGLU, head dim 256 at full width), phi4-mini-3.8b (GQA 24/8) and
qwen1.5-110b (QKV bias, an untied head), each on its smoke config (2
layers, d 128), inputs made from a seed with numpy, both packages from
the reference's parameters carried across. The checks and their
tolerances are ``tests/lm_parity.py``'s: float32 for every arch, and
bfloat16 once for the family, on qwen1.5-110b (its bias and untied
head). Then each arch's config field for field (mamba2-780m's and
zamba2-2.7b's too, whose models ``tests/test_torch_ssm.py`` and
``test_torch_hybrid.py`` hold), and the serve and train command lines on
the CPU.
"""
import dataclasses
import math

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
from repro_torch.models.registry import get_model

ARCHS = ("gemma-2b", "phi4-mini-3.8b", "qwen1.5-110b")
# ArchConfig.param_count() at full size (embeddings included)
FULL_PARAMS = {"gemma-2b": 2_506_170_368, "phi4-mini-3.8b": 3_836_411_904,
               "qwen1.5-110b": 111_209_906_176,
               "mamba2-780m": 780_464_640, "zamba2-2.7b": 2_340_838_848}
CASES = [(a, "float32") for a in ARCHS] + [("qwen1.5-110b", "bfloat16")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def ref(request):
    return P.reference(*request.param)


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
    P.check_loss(ref)


@pytest.mark.parametrize("arch", ARCHS + ("mamba2-780m", "zamba2-2.7b"))
def test_config_matches_reference(arch):
    """Every field of both configs equal to the reference's, the analytic
    parameter count too; the registry serves the arch."""
    for mine, theirs in ((get_config, j_config),
                         (get_smoke_config, j_smoke_config)):
        assert (dataclasses.asdict(mine(arch))
                == dataclasses.asdict(theirs(arch)))
        assert mine(arch).param_count() == theirs(arch).param_count()
    assert get_config(arch).param_count() == FULL_PARAMS[arch]
    assert get_model(get_config(arch)).decode_step is TT.decode_step


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_cli_on_the_cpu(arch, capsys):
    """``launch.serve --smoke`` and ``launch.train --smoke`` with
    ``--device cpu``: the reference's lines, finite losses."""
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"arch={arch} batch=2 prefill=")
    assert lines[0].endswith("tok/s/batch")
    assert lines[1].startswith("generated token ids (first row): ")
    out = train.main(["--arch", arch, "--smoke", "--steps", "2",
                      "--log-every", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    n = sum(p.numel() for p in tree.leaves(out["params"]))
    assert lines[0] == f"arch={arch} params={n:,} method=rage_k"
    assert len(lines) == 3 and all(map(math.isfinite, out["losses"]))
