"""Whole runs: no card, no result; the isolation check; a run driven on
the CPU at a tiny size (the look for a card skipped) with the timed path
broken underneath comes out not correct, as does a window in which a plain
version ran or a kernel launched too seldom, and the control does not pass
the cell's limits. A run on the card where there is one."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH

ROOT = os.path.dirname(BENCH)
SEED = 2 ** 31 + 4242          # past 32 signed bits


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "devis_r50_yt19.train",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_isolation_check_finds_a_banned_import(tmp_path, monkeypatch):
    import harness
    assert harness.isolation_findings() == []
    assert not any(m.split(".")[0] in harness.BANNED for m in sys.modules)
    bad = tmp_path / "reference"
    bad.mkdir()
    (bad / "x.py").write_text("import devis_torch.models\nfrom jax import numpy\n")
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    found = harness.isolation_findings()
    assert any("devis_torch" in f for f in found) and any("jax" in f for f in found)


def _run(harness, cell):
    return harness.run(cell, SEED, 2.0, False, device="cpu", log=lambda m: None)


def test_a_tiny_run_is_correct_and_reports_its_metrics(tiny):
    out = _run(tiny, "devis_r50_yt19.train")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_frames_per_s", "train_peak_gib", "setup_s"}
    assert list(out)[-1] == "checks" and out["attempted"] >= 1 and out["failed"] == 0
    json.dumps(out)


def test_a_tiny_traced_run_reads_its_host_metrics(tiny):
    out = tiny.run("devis_r50_yt19.train", SEED, 2.0, True, device="cpu", log=lambda m: None)
    assert {"step_mfu.train", "loader_wait_ms.train"} <= set(out["metrics"])
    assert "breakdown" in out and out["device"]["window_s"] > 0


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(tiny, monkeypatch):
    from devis_torch import engine

    def unchanged(self):
        self.step += 1
        return engine.global_norm(self.model.parameters())
    monkeypatch.setattr(engine.TrainState, "apply_gradients", unchanged)
    out = _run(tiny, "devis_r50_yt19.train")
    assert not out["correct"]
    assert out["checks"]["change_3"]["value"] == pytest.approx(1.0, abs=0.05)
    assert out["checks"]["grad_shape_q75_1"]["value"] == pytest.approx(1.0, abs=0.05)


def test_a_plain_call_or_a_missing_launch_is_not_correct(tiny):
    per = {"m.k1": 6, "m.k5": 12, "m.taps": None}
    ok = {"m.k1": (60, 0), "m.k5": (120, 0), "m.taps": (None, 0)}
    assert tiny.launch_checks(ok, per, 10) == {"plain_calls": [0.0, 0.0],
                                               "launch_gap": [0.0, 0.0]}
    assert tiny.launch_checks(dict(ok, **{"m.taps": (None, 2)}), per, 10)["plain_calls"][0] == 2
    assert tiny.launch_checks(dict(ok, **{"m.k5": (119, 0)}), per, 10)["launch_gap"][0] == 1


def test_every_counted_op_resolves_to_a_wrapper_with_counters(tiny):
    per = tiny.load("workloads", "devis_r50_yt19.train")["kernel_launches_per_step"]
    ops = tiny.kernel_ops(per)
    tiny.reset_counts(ops)
    assert tiny.counts(ops) == {n: (None if k is None else 0, 0) for n, k in per.items()}


@pytest.mark.parametrize("cell", ["devis_r50_yt19.train"])
def test_the_control_fails_the_cell_s_limits(tiny, cell):
    su = tiny.Setup(cell, SEED, "cpu")
    limits = su.wl["limits"]
    conf, ds, sd = su.conf, su.ds, su.sd
    su.close()
    ref = tiny.reference_steps(conf, ds, sd, 3, "cpu")
    ctl = tiny.reference_steps(conf, ds, sd, 3, "cpu", dtype=torch.float8_e4m3fn)
    checks = tiny.judge(ctl, ref, limits)
    assert any(v > lim for v, lim in checks.values()), checks


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "devis_r50_yt19.train",
                        "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert np.isfinite(out["metrics"]["train_frames_per_s"]["value"])
