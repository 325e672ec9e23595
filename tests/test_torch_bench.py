"""The port's headline bench, as its CPU smoke.

``python -m arcticinference_tpu_torch.bench --device cpu`` runs the JAX
bench's tiny CPU configuration end to end (greedy decode at batch 4 and
1, the decode step through ``runner.dispatch``, drafter distillation on
the first run, the spec phase, the corruption curve and the held-out
point) and prints one JSON line with every key; the device metrics are
null there, since a CPU run measures no device.  The drafter goes to a
temporary directory, not the repository's ``checkpoints/``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

KEYS = {
    "metric", "value", "unit", "baseline_tokens_per_s", "baseline_source",
    "vs_baseline", "decode_only", "device", "card", "batch", "prompt_len",
    "gen_len", "finished", "single_seq_finished", "wall_ms_per_step",
    "device_ms_per_step", "dispatch_ms_per_step", "step_bytes",
    "hbm_gbps_achieved", "hbm_gbps_probe", "hbm_gbps_read_probe",
    "hbm_gbps_xor_probe", "hbm_gbps_peak_nominal", "pct_hw_peak",
    "single_seq_decode_tokens_per_s", "spec_decode_tokens_per_s",
    "spec_step_ms_wall", "spec_step_gbps",
    "greedy_decode_tokens_per_s_same_batch", "spec_speedup",
    "spec_acceptance_rate", "spec_tokens_per_step", "spec_num_drafts",
    "spec_finished", "spec_batch", "spec_width_stats",
    "drafter_distilled_here", "drafter_train_acc", "drafter_capture_s",
    "drafter_train_s", "spec_curve", "spec_heldout",
}
DEVICE_ONLY = ("device_ms_per_step", "dispatch_ms_per_step",
               "hbm_gbps_achieved", "hbm_gbps_probe", "hbm_gbps_read_probe",
               "hbm_gbps_xor_probe", "hbm_gbps_peak_nominal", "pct_hw_peak",
               "card")


@pytest.fixture(scope="module")
def bench_line(tmp_path_factory):
    drafter = tmp_path_factory.mktemp("bench") / "drafter"
    env = dict(os.environ, ARCTIC_BENCH_DRAFTER=str(drafter),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "arcticinference_tpu_torch.bench",
         "--device", "cpu", "--curve-rates", "0.3,1.0"],
        capture_output=True, text=True, timeout=600, cwd=str(REPO), env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout       # stdout is one JSON line
    return json.loads(lines[0]), drafter


def test_prints_every_key(bench_line):
    out, _ = bench_line
    assert set(out) == KEYS, (KEYS - set(out), set(out) - KEYS)
    assert out["metric"] == "cpu_smoke_tokens_per_s"
    assert out["device"] == "cpu"
    for key in DEVICE_ONLY:
        assert out[key] is None, key


def test_every_batch_finishes(bench_line):
    out, _ = bench_line
    assert out["finished"] == out["batch"] == 4
    assert out["single_seq_finished"] == 1
    assert out["spec_finished"] == out["spec_batch"] == 4
    assert np.isfinite(out["value"]) and out["value"] > 0
    assert out["step_bytes"] > 0


def test_distilled_drafter_is_accepted(bench_line):
    out, drafter = bench_line
    assert out["drafter_distilled_here"]
    assert (drafter / "config.json").exists()
    assert (drafter / "model.safetensors").exists()
    assert out["spec_num_drafts"] > 0
    assert out["spec_acceptance_rate"] > 0.5
    assert out["spec_width_stats"]["wide"] > 0
    assert [p["corrupt_rate"] for p in out["spec_curve"]] == [0.3, 1.0]
    # Every draft token corrupted: nothing is accepted.
    assert out["spec_curve"][1]["acceptance"] == 0.0
    assert set(out["spec_heldout"]) >= {"acceptance", "tokens_per_s",
                                        "speedup"}
