"""The port's examples run end to end on the CPU in a subprocess, at their
tiny sizes (``--cpu``), and without ``--cpu`` they refuse to run on a host
that has no CUDA card."""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch_threads import THREADS, capped_torch_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("torch_end_to_end.py", "torch_serving_demo.py", "torch_transcribe_demo.py")


def _run(name: str, *args: str, timeout: float = 500) -> subprocess.CompletedProcess:
    """The example in a child process, its torch ops on ``THREADS`` threads (see
    ``torch_threads.py``)."""
    return subprocess.run([sys.executable, os.path.join(REPO, "examples", name), *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS=str(THREADS)))


def test_transcribe_demo(tmp_path):
    r = _run("torch_transcribe_demo.py", "--cpu", "--outdir", str(tmp_path), "--seconds", "2.5")
    assert r.returncode == 0, r.stderr[-2000:]
    for fmt in ("txt", "srt", "vtt", "json"):
        assert (tmp_path / f"demo.{fmt}").stat().st_size > 0
    assert json.loads((tmp_path / "demo.json").read_text())["segments"]
    assert (tmp_path / "demo.vtt").read_text().startswith("WEBVTT")
    assert "[2] whisper-tiny on cpu" in r.stdout and r.stdout.rstrip().endswith("done")


def test_serving_demo():
    r = _run("torch_serving_demo.py", "--cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("bucket=") == 4
    assert "late: queue=" in r.stdout and "'live_rows': 0" in r.stdout
    assert r.stdout.rstrip().endswith("done.")


def test_end_to_end(tmp_path):
    r = _run("torch_end_to_end.py", "--cpu", "--workdir", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    for step in ("[1/5]", "[2/5] training 1 epoch on cpu", "[3/5]", "[4/5]", "[5/5]", "DONE."):
        assert step in r.stdout
    assert (tmp_path / "avsr.pt2").stat().st_size > 1000
    assert any(name.endswith(".pt") for _, _, files in os.walk(tmp_path / "checkpoints")
               for name in files)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_refuse_a_host_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    r = _run(name, *(("--workdir", str(tmp_path)) if name == "torch_end_to_end.py" else ()),
             *(("--outdir", str(tmp_path)) if name == "torch_transcribe_demo.py" else ()),
             timeout=120)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
