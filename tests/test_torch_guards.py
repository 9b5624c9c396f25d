"""The PyTorch port stands alone, runs on CUDA unless asked otherwise, and
refuses what it does not port yet."""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import xspect2_tpu_torch
from xspect2_tpu_torch import classify, model_cache
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel
from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "xspect2_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'xspect2_tpu' or m.startswith('xspect2_tpu.')]\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(MODULES) >= 20


def test_port_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\b|xspect2_tpu\b(?!_torch))", re.MULTILINE
    )
    sources = [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
    hits = [str(p) for p in sources if pattern.search(p.read_text(encoding="utf-8"))]
    assert hits == []


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, data_root, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model_cache.clear()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classify.classify_species("Anything", tmp_path / "in.fq", tmp_path / "out.json")
    with pytest.raises(RuntimeError):
        classify.classify_genus("Anything", tmp_path / "in.fq", tmp_path / "out.json")
    with pytest.raises(RuntimeError):
        xspect2_tpu_torch.resolve_device("cuda")
    assert xspect2_tpu_torch.resolve_device("cpu").type == "cpu"


def _small_model(tmp_path):
    idx = BlockedBitSlicedIndex.create(21, ["a", "b"], 1000, num_hashes=3)
    model = ProbabilisticFilterModel(21, "Tiny", None, None, "Species", tmp_path, device="cpu")
    model.index = idx
    model.display_names = {"a": "Tiny a", "b": "Tiny b"}
    return model


def test_ragged_input_and_unported_options_raise(tmp_path):
    model = _small_model(tmp_path)
    ragged = tmp_path / "ragged.fasta"
    ragged.write_text(">r1\n" + "A" * 100 + "\n>r2\n" + "C" * 120 + "\n", encoding="utf-8")
    with pytest.raises(NotImplementedError, match="records slice"):
        model.predict(ragged)
    even = tmp_path / "even.fasta"
    even.write_text(">r1\n" + "A" * 100 + "\n>r2\n" + "C" * 100 + "\n", encoding="utf-8")
    with pytest.raises(NotImplementedError, match="records slice"):
        model.predict(even, validation=True)
    with pytest.raises(NotImplementedError, match="records slice"):
        model.fit(tmp_path)
    assert set(model.predict(even).hits) == {"r1", "r2"}
    with pytest.raises(NotImplementedError, match="xxh3"):
        ProbabilisticSingleFilterModel(21, "G", None, None, "Genus", tmp_path, hash_family="xxh3")


def test_saved_model_loads_back(tmp_path):
    model = _small_model(tmp_path)
    model.index.table[:] = np.arange(model.index.table.size, dtype=np.uint32)
    model.save()
    loaded = ProbabilisticFilterModel.load(tmp_path / "tiny-species.json", device="cpu")
    assert loaded.to_dict() == model.to_dict()
    np.testing.assert_array_equal(loaded.index.table, model.index.table)
