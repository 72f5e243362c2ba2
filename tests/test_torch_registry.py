"""The port's model registry (``repro_torch.models.registry``) against the
JAX package's: ``input_specs`` and ``decode_input_specs`` give the
reference's shapes and dtypes for every arch (``meta`` tensors against
its ``ShapeDtypeStruct``s, no allocation) at ``tests/test_models_smoke.py``'s
smoke shapes on the smoke configs and at ``TRAIN_4K``, ``PREFILL_32K`` and
``DECODE_32K`` on the full ones; ``concrete_batch`` draws those shapes
from a torch generator, ints in [0, vocab_size) and floats standard
normal in the spec's dtype, the same batch from the same seed. JAX's
draws differ from torch's, so the draws are held to these semantics, not
to the reference's values.
"""
import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke_config
from repro.models import registry as JR

from repro_torch.configs import (DECODE_32K, PREFILL_32K, TRAIN_4K,
                                 InputShape, get_config, get_smoke_config)
from repro_torch.models import registry as TR
from repro_torch.models import transformer as TT

SMOKE_TRAIN = InputShape("smoke_train", 64, 2, "train")
SMOKE_PREFILL = InputShape("smoke_prefill", 64, 2, "prefill")
SMOKE_DECODE = InputShape("smoke_decode", 64, 2, "decode")
FULL = (TRAIN_4K, PREFILL_32K, DECODE_32K)


def _like(specs) -> dict:
    """{name: (shape, dtype name)} of meta tensors or ShapeDtypeStructs."""
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in specs.items()}


def _cases():
    for arch in ASSIGNED_ARCHS:
        for shape in (SMOKE_TRAIN, SMOKE_PREFILL, SMOKE_DECODE):
            yield pytest.param(arch, shape, True, id=f"{arch}-{shape.name}")
        for shape in FULL:
            yield pytest.param(arch, shape, False, id=f"{arch}-{shape.name}")


@pytest.mark.parametrize("arch,shape,smoke", list(_cases()))
def test_specs_match_reference(arch, shape, smoke):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    jcfg = j_smoke_config(arch) if smoke else j_config(arch)
    got = TR.input_specs(cfg, shape)
    assert all(t.device.type == "meta" for t in got.values())
    assert _like(got) == _like(JR.input_specs(jcfg, shape))
    inputs, cache = TR.decode_input_specs(cfg, shape)
    jinputs, jcache = JR.decode_input_specs(jcfg, shape)
    assert all(t.device.type == "meta"
               for t in (*inputs.values(), *cache.values()))
    assert _like(inputs) == _like(jinputs)
    assert _like(cache) == _like(jcache)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "pixtral-12b",
                                  "whisper-large-v3"])
def test_concrete_batch_in_range_and_reproducible(arch):
    cfg = get_smoke_config(arch)
    batches = [TR.concrete_batch(cfg, SMOKE_TRAIN, torch.Generator()
                                 .manual_seed(seed), device="cpu")
               for seed in (0, 0, 1)]
    specs = TR.input_specs(cfg, SMOKE_TRAIN)
    assert _like(batches[0]) == _like(specs)
    for name, t in batches[0].items():
        assert torch.equal(t, batches[1][name])
        assert not torch.equal(t, batches[2][name])
        if t.dtype == torch.int32:
            assert 0 <= int(t.min()) and int(t.max()) < cfg.vocab_size
        else:
            x = t.float()
            assert abs(float(x.mean())) < 0.05 and \
                abs(float(x.std()) - 1) < 0.05
    # the port's loss runs on the batch
    params = TT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    loss, _ = TT.loss_fn(params, cfg, batches[0])
    assert loss.shape == () and np.isfinite(float(loss))


def test_concrete_batch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.concrete_batch(get_smoke_config("pixtral-12b"), SMOKE_TRAIN,
                          torch.Generator())


def test_every_family_has_its_model():
    """``get_model`` serves every LM family the reference has; the
    paper's nets are refused."""
    for arch in ASSIGNED_ARCHS:
        assert TR.get_model(get_config(arch)).decode_step is TT.decode_step
    for arch in ("mnist-mlp", "cifar-cnn"):
        with pytest.raises(ValueError, match="not an LM"):
            TR.get_model(get_config(arch))
