"""The command on the card: one short run of the build cell prints a
result line that meets the contract.  Needs a CUDA card (``gpu``)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the command exits without one")


@pytest.mark.gpu
def test_build_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "anns_bench/run.py", "--workload", "sift1m-q8.build",
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert line["correct"] and line["failed"] == 0
    assert {"build_vps", "setup_s"} <= set(line["metrics"])
    assert line["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("[check]")


def test_the_command_refuses_a_machine_without_enough_cards():
    code = ("import sys, runpy, torch; torch.cuda.is_available = lambda: False;"
            "sys.argv = ['run.py', '--workload', 'sift1m-q8.build', '--seed',"
            " '1', '--seconds', '1'];"
            "runpy.run_path('anns_bench/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_the_command_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and anns_bench/, with
    a card (faked here), the command fails before it prints a result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "anns_bench", tmp_path / "anns_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy, torch; torch.cuda.is_available = lambda: True;"
            "torch.cuda.device_count = lambda: 1;"
            "sys.argv = ['run.py', '--workload', 'sift1m-q8.build', '--seed',"
            " '1', '--seconds', '1'];"
            "runpy.run_path('anns_bench/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "repro_torch" in out.stderr
