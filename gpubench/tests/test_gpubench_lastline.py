"""The result line, the exit without a card, and the exit in a directory
without the program."""

import json
import shutil
import subprocess
import sys

import pytest

from gpubench import layout
from gpubench.testing import run_small

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_contract_keys(trace):
    result, out, err = run_small("mamba-h13.serve", trace=trace,
                                 precision="float32")
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    for k, v in line["checks"].items():
        assert set(v) == {"value", "limit"}
        assert "check {}: ".format(k) in err
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == {"serve_windows_per_s", "setup_s"}


def test_train_line_reports_its_metrics():
    result, _, _ = run_small("fusatnet-h13.train", precision="float32")
    assert set(result["metrics"]) == {"train_patches_per_s", "setup_s"}
    assert result["attempted"] > 0


def command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         "mamba-h13.serve", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=600)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = command(layout.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_alone_has_no_result(tmp_path):
    shutil.copy(layout.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(layout.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = command(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
