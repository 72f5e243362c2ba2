"""The port's command line (``python -m repro_torch.launch.fl_train``) and
its examples, on the CPU.

The reference's rejections (``tests/test_config_validation.py``), the
smokes of its CI workflow at ``--n-train 600`` and a few rounds (uniform
m 8, hierarchical against dense, the async buffered PS, the fault gate,
``--aggregate jnp`` against ``pallas``), one parity case against the
reference's own ``fl_train.main`` at the same flags (the ``--out`` key
sets, uplink, downlink, schedule and participation equal; losses differ,
the initial weights coming from other generators), kill-and-resume
through subprocesses with a byte-equal ``--out``, and the quickstart and
federated-MNIST examples.
"""
import filecmp
import json
import math
import os
import subprocess
import sys

import pytest
from torch_threads import share_cores

torch = pytest.importorskip("torch")
share_cores(torch)

from repro.launch import fl_train as jfl_train

from repro_torch.examples import federated_mnist, quickstart
from repro_torch.launch import fl_train

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
CPU = ("--device", "cpu", "--n-train", "600")
SYNC_KEYS = {"rounds", "acc", "loss", "uplink", "clusters", "schedule",
             "n_active", "aoi_mean", "aoi_peak", "age_mean", "age_peak",
             "n_quarantined", "n_crashed", "n_dropped"}
ASYNC_KEYS = {"driver", "rounds", "acc", "loss", "uplink", "downlink",
              "clock", "aggregations", "staleness_hist", "clusters",
              "buffer_k", "staleness_eta", "version_window", "solicit",
              "quarantined", "crashed", "dropped", "retried"}


def _run(tmp_path, name, *argv):
    """``main`` in this process with ``--out`` into tmp_path; returns the
    parsed JSON and its path."""
    out = tmp_path / f"{name}.json"
    fl_train.main([*CPU, *argv, "--out", str(out)])
    with open(out) as f:
        return json.load(f), out


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ("--candidates", "magic"),
    ("--schedule", "sometimes"),
    ("--method", "nope"),
    ("--compute", "telepathic"),
    ("--driver", "warp"),
    ("--aggregate", "xla"),
])
def test_cli_rejects_unknown_choice(capsys, argv):
    with pytest.raises(SystemExit) as ei:
        fl_train.main([*CPU, *argv])
    assert ei.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("argv, match", [
    (("--schedule", "uniform", "--participation-m", "99"), "1 <= m <= N"),
    (("--schedule", "uniform", "--participation-m", "-3"),
     "participation_m"),
    (("--schedule", "deadline", "--deadline-s", "-1"), "deadline_s"),
    (("--r", "5", "--k", "10"), "r >= k"),
    (("--kill-at-round", "2"), "--ckpt-dir"),
])
def test_cli_rejects_bad_values(argv, match):
    with pytest.raises((ValueError, SystemExit), match=match):
        fl_train.main([*CPU, *argv, "--rounds", "1"])


def test_cli_needs_the_card_by_default(monkeypatch):
    """Without ``--device`` the CLI runs on the card and raises without
    one; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fl_train.main(["--n-train", "600", "--rounds", "1"])


# ---------------------------------------------------------------------------
# the CI smokes
# ---------------------------------------------------------------------------

def test_schedule_smoke(tmp_path):
    d, _ = _run(tmp_path, "schedule", "--rounds", "3", "--schedule",
                "uniform", "--participation-m", "8")
    assert set(d) == SYNC_KEYS
    assert d["schedule"] == "uniform"
    assert d["n_active"] == [8] * 3
    assert max(d["aoi_peak"]) >= 1


def test_age_layout_smoke(tmp_path):
    """Hierarchical against dense across two reclusters (M 2): loss,
    accuracy, clusters and uplink equal."""
    a, _ = _run(tmp_path, "hier", "--rounds", "4", "--M", "2",
                "--age-layout", "hierarchical")
    b, _ = _run(tmp_path, "dense", "--rounds", "4", "--M", "2")
    for key in ("loss", "acc", "clusters", "uplink", "age_mean"):
        assert a[key] == b[key], key


def test_async_smoke(tmp_path):
    d, _ = _run(tmp_path, "async", "--rounds", "3", "--driver", "async",
                "--buffer-k", "4")
    assert set(d) == ASYNC_KEYS
    assert d["driver"] == "async" and d["buffer_k"] == 4
    assert d["aggregations"] == 3
    assert d["clock"] == sorted(d["clock"])
    hist = {int(k): v for k, v in d["staleness_hist"].items()}
    assert sum(hist.values()) == 3 * 4
    assert max(hist) <= d["version_window"] - 1
    assert d["downlink"][-1] > 0


def test_faults_smoke(tmp_path):
    d, _ = _run(tmp_path, "faults", "--rounds", "5", "--faults", "nan:0.1")
    assert sum(d["n_quarantined"]) > 0
    assert all(math.isfinite(x) for x in d["loss"])


def test_aggregate_jnp_equals_pallas(tmp_path):
    """Four rounds across a recluster (M 2): the two hand-offs give the
    same ``--out``."""
    _, a = _run(tmp_path, "jnp", "--rounds", "4", "--M", "2",
                "--aggregate", "jnp")
    _, b = _run(tmp_path, "pallas", "--rounds", "4", "--M", "2",
                "--aggregate", "pallas")
    assert filecmp.cmp(a, b, shallow=False)


# ---------------------------------------------------------------------------
# parity with the reference's CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["scan", "async"])
def test_out_matches_reference_cli(tmp_path, monkeypatch, driver):
    argv = ["--n-train", "600", "--rounds", "2", "--driver", driver]
    if driver == "async":
        argv += ["--buffer-k", "4"]
    ref = tmp_path / "ref.json"
    monkeypatch.setattr(sys, "argv", ["fl_train", *argv, "--out", str(ref)])
    jfl_train.main()
    with open(ref) as f:
        want = json.load(f)
    got, _ = _run(tmp_path, "port", *argv[2:])
    assert set(got) == set(want)
    assert got["uplink"] == want["uplink"]
    assert got["rounds"] == want["rounds"]
    if driver == "async":
        assert got["downlink"] == want["downlink"]
        for key in ("aggregations", "buffer_k", "version_window", "solicit"):
            assert got[key] == want[key], key
    else:
        assert got["schedule"] == want["schedule"]
        assert got["n_active"] == want["n_active"]


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------

def test_kill_and_resume_byte_equal(tmp_path):
    """The crash injector exits 17 after the round-4 checkpoint commits;
    the resumed run replays the rest and writes the uninterrupted run's
    ``--out`` byte for byte."""
    # each process gets this worker's share of the cores (share_cores)
    env = {**os.environ, "PYTHONPATH": SRC,
           "OMP_NUM_THREADS": str(torch.get_num_threads())}

    def cli(*argv):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.fl_train", *CPU,
             "--rounds", "6", "--ckpt-every", "2", *argv],
            env=env, capture_output=True, text=True, timeout=300)

    ref = cli("--ckpt-dir", str(tmp_path / "ck_ref"), "--out",
              str(tmp_path / "ref.json"))
    assert ref.returncode == 0, ref.stderr
    killed = cli("--ckpt-dir", str(tmp_path / "ck"), "--kill-at-round", "4",
                 "--out", str(tmp_path / "killed.json"))
    assert killed.returncode == 17, killed.stderr
    assert "committed step 4" in killed.stdout
    assert not (tmp_path / "killed.json").exists()
    done = cli("--ckpt-dir", str(tmp_path / "ck"), "--resume", "--out",
               str(tmp_path / "done.json"))
    assert done.returncode == 0, done.stderr
    assert "resumed at round 4" in done.stdout
    assert filecmp.cmp(tmp_path / "ref.json", tmp_path / "done.json",
                       shallow=False)


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def test_quickstart_finds_the_two_groups(capsys):
    labels = quickstart.main(["--device", "cpu"])
    assert labels.tolist() == [0, 0, 1, 1]
    assert "clusters found: [0, 0, 1, 1]" in capsys.readouterr().out


def test_federated_mnist_runs():
    out = federated_mnist.main(["--rounds", "2", "--device", "cpu"])
    assert set(out) == {"rage_k", "rtop_k"}
    for res in out.values():
        assert res.rounds == [1, 2]
        assert all(math.isfinite(x) for x in res.loss)
