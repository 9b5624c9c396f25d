"""The port's product demo (``xspect2_tpu_torch/tools/demo_e2e.py``) writes
the JAX tool's files.

Both demos run at a tiny size (50 kbp genomes, 600 reads) from the same
seed, each in its own temporary directory (its ``XSPECT_DATA_ROOT``)
with its own CLI reloaded: the port's with ``--device cpu``, the JAX
tool (``tools/demo_e2e.py``, loaded from its file) as it is, kept with
``--keep``.  The training tree, the sample, the model files and the
``all`` pipeline's outputs must be byte-identical; the pipeline's file
names and their contents carry a ``uuid4`` each run draws, matched as a
placeholder.
"""

import importlib.util
import os
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from tests.test_torch_cli import assert_same_files
from tests.test_torch_train import _assert_same_tree
from xspect2_tpu import model_cache as jax_model_cache
from xspect2_tpu_torch import model_cache
from xspect2_tpu_torch.tools import demo_e2e

ROOT = Path(__file__).resolve().parent.parent
FLAGS = ["--genome-mb", "0.05", "--reads", "600"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_demo_e2e", ROOT / "tools" / "demo_e2e.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _only_dir(parent: Path) -> Path:
    (found,) = [p for p in parent.iterdir() if p.is_dir()]
    return found


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    """{"jax": tmp dir, "port": tmp dir} of one run of each demo, and the
    port's model cache after its run ("cached")."""
    base = tmp_path_factory.mktemp("demo")
    old_root, old_tempdir, old_argv = os.environ.get("XSPECT_DATA_ROOT"), tempfile.tempdir, sys.argv
    dirs = {}
    try:
        for name in ("jax", "port"):
            jax_model_cache.clear()
            model_cache.clear()
            tempfile.tempdir = str(base / name)
            (base / name).mkdir()
            if name == "jax":
                sys.argv = ["demo_e2e.py", *FLAGS, "--keep"]
                _jax_tool().main()
            else:
                demo_e2e.main([*FLAGS, "--keep", "--device", "cpu"])
                dirs["cached"] = sorted(model_cache._CACHE)
            dirs[name] = _only_dir(base / name)
    finally:
        tempfile.tempdir, sys.argv = old_tempdir, old_argv
        if old_root is None:
            os.environ.pop("XSPECT_DATA_ROOT", None)
        else:
            os.environ["XSPECT_DATA_ROOT"] = old_root
        jax_model_cache.clear()
        model_cache.clear()
    return dirs


@pytest.mark.parametrize("part", ["train", "models", "out"])
def test_demo_writes_the_jax_tools_files(demos, part):
    got, want = demos["port"] / part, demos["jax"] / part
    if part == "out":
        files = assert_same_files(got, want)
        assert any(rel.startswith("species_classification_") for rel in files)
        assert any(rel.startswith("filtered_sequences/genus_filtered_") for rel in files)
    else:
        _assert_same_tree(got, want)
    assert (demos["port"] / "sample.fasta").read_bytes() == (demos["jax"] / "sample.fasta").read_bytes()


def test_demo_models_load_on_the_cli_device(demos):
    """``--device cpu`` at the CLI's root reaches every model that ``all``
    loads: the genus filter's and the species step's, both on the CPU."""
    assert [(cls, Path(path).name, device) for cls, path, device in demos["cached"]] == [
        ("ProbabilisticFilterSVMModel", "testus-species.json", "cpu"),
        ("ProbabilisticSingleFilterModel", "testus-genus.json", "cpu"),
    ]


def test_demo_without_keep_removes_its_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "unused"))
    model_cache.clear()
    gone = demo_e2e.main([*FLAGS, "--device", "cpu"])
    model_cache.clear()
    assert gone.parent == tmp_path and not gone.exists()


def test_demo_needs_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "unused"))
    for argv in (FLAGS, [*FLAGS, "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            demo_e2e.main(argv)
    assert list(tmp_path.iterdir()) == []
