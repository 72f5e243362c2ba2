"""The port's LM training command line (``python -m
repro_torch.launch.train``) and the distributed example
(``repro_torch.examples.distributed_ragek_lm``), on the CPU.

The command prints the reference's lines; its losses are held to the
reference's own library loop (``make_sync_train_step`` jitted, Adam
1e-3, ``token_stream`` from seed 1) started from the port's seed-0
weights carried across: within 2e-3 over 6 steps (the smoke config
computes in bfloat16, and the two packages round its activations and
sums in other places: up to 5.6e-4 seen, dense). The checkpoint it writes is
read by the reference's ``load_checkpoint``, bfloat16 leaves included.
The dense full-width wire stat, 3,399,684,096 B a step, is past int32:
the reference's int32 cast overflows there (ROADMAP queue 3, fault 7),
the port's count is an exact host int.
"""
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

import jax
import jax.numpy as jnp

from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.core.sparsify import bucket_budgets
from repro.dist import sparse_sync as JS
from repro.optim import optimizers as JO

import lm_parity as P
from repro_torch import tree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist import sparse_sync as TS
from repro_torch.examples import distributed_ragek_lm
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as TT

ARCH = "internlm2-1.8b"
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
STEPS = 6
LOSS_TOL = 2e-3
# internlm2-1.8b at full width: its 11 leaves, in tree_leaves order
FULL_PARAMS = 1_699_842_048


@pytest.fixture(scope="module")
def port_init():
    cfg = get_smoke_config(ARCH).replace(remat=False)
    return TT.init(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("method", ["rage_k", "dense"])
def test_train_cli_matches_reference_loop(capsys, port_init, method):
    out = train.main(["--smoke", "--steps", str(STEPS), "--log-every", "2",
                      "--method", method, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch={ARCH} params=361,088 method={method}"
    pat = re.compile(r"step +(\d+) loss=(\d+\.\d{4}) steps/s=\d+\.\d\d "
                     r"wire=(\d+\.\d\d)MiB/shard$")
    logged = [pat.match(l) for l in lines[1:]]
    assert all(logged) and [int(m.group(1)) for m in logged] == [2, 4, 6]
    want, wire = P.reference_cli_losses(ARCH, P.to_jax(port_init), method,
                                        STEPS)
    np.testing.assert_allclose(out["losses"], want, atol=LOSS_TOL, rtol=0)
    for m in logged:
        i = int(m.group(1))
        assert abs(float(m.group(2)) - out["losses"][i - 1]) <= 5e-5
    assert out["wire_bytes"] == wire
    assert float(logged[-1].group(3)) == round(wire / 2**20, 2)


def test_train_cli_defaults_to_the_card(monkeypatch):
    """Without --device the run is on the card: with none it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed_ragek_lm.main(["--steps", "1"])


def test_train_cli_rejects_unported_arch(capsys):
    """The VLM and audio archs are refused before a device is touched
    (the token stream makes no ``embeds`` or ``frames``: ROADMAP queue 3,
    fault 9), as is an unknown method."""
    for arch in ("pixtral-12b", "whisper-large-v3"):
        with pytest.raises(ValueError, match="fault 9"):
            train.main(["--arch", arch, "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):
        train.main(["--method", "top_k", "--device", "cpu"])


def test_train_ckpt_read_by_reference(tmp_path, capsys):
    """--ckpt writes the reference's on-disk layout: its
    ``load_checkpoint`` reads every leaf, bfloat16 ones included, equal to
    the port's parameters."""
    out = train.main(["--smoke", "--steps", "2", "--device", "cpu",
                      "--ckpt", str(tmp_path)])
    assert capsys.readouterr().out.strip().endswith(
        f"saved checkpoint to {tmp_path}")
    like = jax.tree_util.tree_map(
        lambda t: np.zeros(t.shape, np.float32), P.to_jax(out["params"]))
    got, meta = j_load_checkpoint(str(tmp_path), like)
    assert meta["step"] == 2
    want = P.to_jax(out["params"])
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))
    assert any(np.asarray(b).dtype.name == "bfloat16"
               for b in jax.tree_util.tree_leaves(want))


def test_module_entry_point(tmp_path):
    """``python -m repro_torch.launch.train`` as a process."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "2", "--log-every", "1", "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert len(res.stdout.strip().splitlines()) == 3


def test_example_runs(capsys):
    """The example at 6 steps: the reference's two lines, finite losses,
    rAge-k's wire far below dense's."""
    res = distributed_ragek_lm.main(["--steps", "6", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [l[:9] for l in lines] == ["[rage_k ]", "[dense  ]"]
    assert all(math.isfinite(r["loss"]) for r in res.values())
    assert res["dense"]["wire_bytes"] == 6 * 361_088 * 2
    assert res["rage_k"]["wire_bytes"] * 100 < res["dense"]["wire_bytes"]
    assert res["rage_k"]["loss"] < 6.3          # below ln 512 + a margin


def test_full_width_wire_stats_are_exact():
    """internlm2-1.8b's 11 leaves at full width on the meta device (no
    memory): the dense single-program and manual wires are 2 B a
    parameter, 3,399,684,096 B, past int32; rAge-k's is 6 B a pick, the
    k_b of ``bucket_budgets`` summed. The reference's int32 stat
    overflows on the dense one (fault 7)."""
    cfg = get_config(ARCH)
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    kv = cfg.n_kv_heads * cfg.head_dim_
    shapes = {"embed": {"w": (cfg.padded_vocab, d)},
              "layers": {"attn": {"wk": (L, d, kv), "wo": (L, d, d),
                                  "wq": (L, d, d), "wv": (L, d, kv)},
                         "ln1": {"scale": (L, d)}, "ln2": {"scale": (L, d)},
                         "mlp": {"w1": (L, d, f), "w2": (L, f, d),
                                 "w3": (L, d, f)}},
              "norm_f": {"scale": (d,)}}
    params = {k: {kk: (torch.empty(vv, dtype=torch.bfloat16, device="meta")
                       if isinstance(vv, tuple) else
                       {n: torch.empty(s, dtype=torch.bfloat16,
                                       device="meta") for n, s in vv.items()})
                  for kk, vv in v.items()} for k, v in shapes.items()}
    sizes = [p.numel() for p in tree.leaves(params)]
    assert sum(sizes) == FULL_PARAMS
    ages = tree.tree_map(lambda p: torch.empty(p.shape, dtype=torch.int32,
                                               device="meta"), params)
    _, _, st = TS.sync_grads(params, ages, method="dense")
    assert st["wire_bytes_per_shard"] == 2 * FULL_PARAMS == 3_399_684_096
    assert st["wire_bytes_per_shard"] > 2 ** 31
    sync = TS.make_manual_sync(
        make_host_mesh(1, 1, device="cpu"), None, params, method="dense")
    _, _, st = sync(params, ages)
    assert st["wire_bytes_per_shard"] == 3_399_684_096
    picks = sum(k for _, k in bucket_budgets(sizes, 2048, 256))
    assert picks == 261
    # the reference's step, traced abstractly on the same shapes
    shapes = [jax.ShapeDtypeStruct((n,), jnp.bfloat16) for n in sizes]
    ref = JS.make_sync_train_step(
        lambda p, b: sum(jnp.sum(x.astype(jnp.float32)) for x in p),
        JO.sgd(1.0), None, method="dense")
    opt_state = jax.eval_shape(JO.sgd(1.0).init, shapes)
    with pytest.raises(OverflowError, match="3399684096"):
        jax.eval_shape(ref, shapes, opt_state,
                       [jax.ShapeDtypeStruct((n,), jnp.int32)
                        for n in sizes], None)
