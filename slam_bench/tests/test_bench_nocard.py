"""A run without the card it needs fails and prints no result; a run
names every number it compares beside its limit."""

import json
import os
import subprocess
import sys

import pytest
import torch

from slam_bench import harness


def test_a_run_without_a_card_fails_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    repo = harness.ROOT.parent
    out = subprocess.run(
        [sys.executable, "slam_bench/run.py", "--workload", "tum-fast.creep-batch",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=repo, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_harness_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.NoCard):
        harness.run("tum-fast.creep-batch", 1, 1.0, False)


def test_only_the_benchmarks_files_are_not_enough(tmp_path):
    (tmp_path / "slam_bench").mkdir()
    for p in harness.ROOT.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            dst = tmp_path / "slam_bench" / p.relative_to(harness.ROOT)
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(p.read_bytes())
    (tmp_path / "BENCHMARK.json").write_bytes(harness.BENCHMARK_JSON.read_bytes())
    out = subprocess.run(
        [sys.executable, "slam_bench/run.py", "--workload", "tum-fast.creep-batch",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout.strip().splitlines()[-1] if out.stdout.strip() else "")
