"""No module the harness or its reference loads is JAX's or the JAX
package's: the top-level name (before the first dot) is compared whole,
since the port's name, ``xspect2_tpu_torch``, begins with the JAX
package's."""

import subprocess
import sys
from pathlib import Path

import pytest

from bench_port import harness

ROOT = Path(__file__).resolve().parents[2]

_PROBE = r"""
import sys, time
sys.path.insert(0, {root!r})
from bench_port import harness, reference, svm_ref, control, spans, tracing, roofline, synthetic
from bench_port.tests import tiny
import bench_port.run
tiny.run("species40-assemblies", seconds=0.2, trace=True)
tiny.run("genus160-reads", seconds=0.2)
print(harness.forbidden_modules())
"""


def test_the_top_level_name_is_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "xspect2_tpu_torch_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", object())
    assert "xspect2_tpu_torch" not in harness.forbidden_modules()
    assert not [m for m in harness.forbidden_modules() if m.endswith("_probe")]
    monkeypatch.setitem(sys.modules, "xspect2_tpu.ops", object())
    assert "xspect2_tpu.ops" in harness.forbidden_modules()


def test_a_run_of_the_harness_and_its_reference_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                                                                  "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """The command exits non-zero and prints no result where no card is."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, str(ROOT / "bench_port" / "run.py"), "--workload", "genus160-reads",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(tmp_path):
    """On the card: one short run of the smallest cell through the command."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(ROOT / "bench_port" / "run.py"), "--workload",
                          "genus160-reads", "--seed", "2147483659", "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "genus160-reads", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""
