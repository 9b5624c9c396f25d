"""The PyTorch port stands alone, runs on CUDA unless asked otherwise, and
refuses what it does not port yet."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import xspect2_tpu_torch
from xspect2_tpu_torch import classify, filter_sequences, model_cache
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.core.compat import XXH3BloomFilter
from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel
from xspect2_tpu_torch.models.mlst_model import ProbabilisticFilterMlstSchemeModel
from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel
from xspect2_tpu_torch.ops.query import DeviceQueryEngine

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "xspect2_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'sklearn', 'xspect2_tpu')]\n"
        "print(json.dumps(bad))\n"
    )
    # the CLI reads the model registry at import: give it an empty one
    env = {**os.environ, "XSPECT_DATA_ROOT": str(tmp_path / "data")}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300, env=env
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(MODULES) >= 30
    for module in (
        "models.mlst_model", "core.compat", "core.xxh3", "handlers.http", "handlers.pubmlst",
        "filter_sequences", "ops.bloom", "ops.probe_select", "parallel", "parallel.mesh",
        "parallel.distributed", "parallel.sharded", "parallel.block_sharded",
        "tools.microbench_probe", "tools.demo_e2e", "train", "handlers.ncbi", "misclassification_detection",
        "misclassification_detection.mapping", "misclassification_detection.point_pattern_analysis",
        "misclassification_detection.simulate_reads", "reference_import", "download_models",
        "main", "web", "webui", "profiling", "pipelines", "pipelines.benchmark",
        "pipelines.pangenome", "pipelines.score_svm",
    ):
        assert f"xspect2_tpu_torch.{module}" in MODULES


def test_the_model_modules_do_not_import_requests(tmp_path):
    """``requests`` is needed by the handlers only, which the MLST model
    imports inside its ST-name lookup, training, the reference import and
    the misclassification detection inside their functions, and the
    bundle download inside its own: a machine without ``requests``
    imports every module and runs every model."""
    models = [m for m in MODULES if ".handlers" not in m]
    code = (
        "import importlib, json, sys\n"
        f"for m in {models!r}: importlib.import_module(m)\n"
        "print(json.dumps([m for m in sys.modules if m.split('.')[0] == 'requests'\n"
        "                  or m.startswith('xspect2_tpu_torch.handlers.')]))\n"
    )
    env = {**os.environ, "XSPECT_DATA_ROOT": str(tmp_path / "data")}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300, env=env
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    for module in ("models.mlst_model", "train", "reference_import", "download_models",
                   "misclassification_detection", "misclassification_detection.mapping"):
        assert f"xspect2_tpu_torch.{module}" in models


def test_port_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\b|sklearn\b|xspect2_tpu\b(?!_torch))", re.MULTILINE
    )
    sources = [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
    hits = [str(p) for p in sources if pattern.search(p.read_text(encoding="utf-8"))]
    assert hits == []
    assert {
        "mlst_model.py", "compat.py", "xxh3.py", "http.py", "pubmlst.py", "bloom.py", "mesh.py",
        "distributed.py", "sharded.py", "block_sharded.py", "probe_select.py", "microbench_probe.py",
        "demo_e2e.py", "train.py", "ncbi.py", "mapping.py", "point_pattern_analysis.py", "simulate_reads.py",
        "reference_import.py", "download_models.py", "main.py", "web.py", "webui.py", "profiling.py",
        "benchmark.py", "pangenome.py", "score_svm.py",
    } <= {p.name for p in sources}


def test_only_ops_query_knows_how_a_prepared_batch_reaches_the_card():
    """The record-slot rule (``_next_pow2``) and the K4 restore of a batch
    (``restore_records_wire``) are ``ops/query.py``'s: every other module
    counts a batch through ``restore_batch`` and the batch's properties."""
    pattern = re.compile(r"\b(_next_pow2|restore_records_wire)\b")
    query_py = PORT / "ops" / "query.py"
    hits = sorted(
        str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
        if p != query_py and pattern.search(p.read_text(encoding="utf-8"))
    )
    assert hits == []
    assert {"_next_pow2", "restore_records_wire"} <= set(pattern.findall(query_py.read_text(encoding="utf-8")))


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, data_root, tmp_path):
    from xspect2_tpu_torch import download_models, reference_import, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("XSPECT_NCBI_URL", "http://127.0.0.1:1")  # nothing may leave the machine
    monkeypatch.setenv("XSPECT_PUBMLST_URL", "http://127.0.0.1:1")
    model_cache.clear()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classify.classify_species("Anything", tmp_path / "in.fq", tmp_path / "out.json")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classify.classify_species("Anything", tmp_path / "in.fq", tmp_path / "out.json", validation=True)
    for entry in (
        lambda: train.train_from_directory("Anything", tmp_path),
        lambda: train.train_from_ncbi("Anything"),
        lambda: train.train_mlst("org", "scheme"),
        lambda: reference_import.import_reference_models(tmp_path),
        lambda: download_models.download_test_models(url="http://127.0.0.1:1/m.zip"),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    assert not list(data_root.glob("models/*.json"))
    with pytest.raises(RuntimeError):
        classify.classify_genus("Anything", tmp_path / "in.fq", tmp_path / "out.json")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classify.classify_mlst(tmp_path / "in.fa", "Anything", "Oxford", tmp_path / "out.json", False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        filter_sequences.filter_species("Anything", "470", tmp_path / "in.fa", tmp_path / "out.fa", 0.7)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        filter_sequences.filter_genus("Anything", tmp_path / "in.fa", tmp_path / "out.fa", 0.7)
    saved = _small_model(tmp_path)
    saved.save()
    for build in (
        lambda: DeviceQueryEngine(saved.index),
        lambda: ProbabilisticFilterModel.load(tmp_path / "tiny-species.json"),
        lambda: ProbabilisticFilterMlstSchemeModel(31, "S", tmp_path, "url", "org"),
        lambda: ProbabilisticSingleFilterModel(21, "G", None, None, "Genus", tmp_path, hash_family="xxh3"),
        lambda: XXH3BloomFilter(1000, 3, 21).count_hits_device(
            np.zeros(1, np.uint32), np.zeros(1, np.uint32), np.ones(1, bool)),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    with pytest.raises(RuntimeError):
        xspect2_tpu_torch.resolve_device("cuda")
    assert xspect2_tpu_torch.resolve_device("cpu").type == "cpu"
    _surfaces_need_cuda_unless_asked_for_cpu(tmp_path, saved)


def _surfaces_need_cuda_unless_asked_for_cpu(tmp_path, saved):
    """The CLI without ``--device`` (a usage error naming ``--device cpu``),
    the web app's tasks (500 with the message; the page and the registry
    answer), the benchmarks, the pangenome training (before its retry
    loop) and the grid search raise without a card."""
    from click.testing import CliRunner
    from werkzeug.test import Client

    from xspect2_tpu_torch import main, pipelines, web
    from xspect2_tpu_torch.pipelines import score_svm

    tree = tmp_path / "tree"
    (tree / "cobs" / "a").mkdir(parents=True)
    for args in (["models", "train", "directory", "-g", "Anything", "-i", str(tree)],
                 ["models", "import", "-p", str(tree)],
                 ["models", "train", "ncbi", "-g", "Anything"]):
        result = CliRunner().invoke(main.cli, args)
        assert result.exit_code == 1 and "device='cpu'" in result.output, result.output
        assert "--device cpu" in result.output
    assert CliRunner().invoke(main.cli, ["models", "list"]).exit_code == 0
    client = Client(web.XspectWebApp())
    assert client.get("/").status_code == 200 and client.get("/api/list-models").status_code == 200
    (tmp_path / "in.fa").write_text(">r\n" + "ACGT" * 20 + "\n", encoding="utf-8")
    with open(tmp_path / "in.fa", "rb") as f:
        assert client.post("/api/upload-file", data={"file": (f, "in.fa")}).status_code == 200
    for url in ("/api/classify?classification_type=Species&model=Anything&file=in.fa",
                "/api/classify?classification_type=Genus&model=Anything&file=in.fa",
                "/api/filter?filter_type=Genus&genus=Anything&input_file=in.fa",
                "/api/filter?filter_type=Species&genus=Anything&input_file=in.fa&filter_species=a",
                "/api/train?genus=Anything"):
        resp = client.post(url)
        assert resp.status_code == 500 and "device='cpu'" in resp.get_json()["detail"], url
    assert web.XspectWebApp().tasks._threads == []
    reads = np.zeros((4, 40), dtype=np.uint8)
    for entry in (
        lambda: pipelines.run_read_benchmark(saved, reads, ["a"] * 4),
        lambda: pipelines.run_assembly_benchmark(saved, []),
        lambda: pipelines.train_pangenome(["Anything"], data_root=tmp_path, retry_delay=0),
        lambda: pipelines.grid_search_svm(np.eye(4), ["a", "a", "b", "b"]),
        lambda: score_svm.grid_search_model(saved),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    assert pipelines.run_read_benchmark(saved, reads, ["a"] * 4, device="cpu").stats["total"] == 4


def test_sharded_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    from xspect2_tpu_torch import parallel
    from xspect2_tpu_torch.parallel import distributed
    from xspect2_tpu_torch.parallel.mesh import BLK_AXIS, CLS_AXIS, DATA_AXIS, Mesh
    from xspect2_tpu_torch.tools import microbench_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx = _small_model(tmp_path).index

    def cuda_mesh(axis):
        return Mesh({DATA_AXIS: 1, axis: 1}, (0, 0), {DATA_AXIS: None, axis: None}, torch.device("cuda"))

    for build in (
        parallel.make_mesh,
        parallel.make_block_mesh,
        distributed.initialize,
        lambda: parallel.ShardedClassifier(idx, cuda_mesh(CLS_AXIS)),
        lambda: parallel.BlockShardedClassifier(idx, cuda_mesh(BLK_AXIS)),
        lambda: microbench_probe.run(table_mb=0.1, reads=8, reads_per_chunk=8, iters=1),
        lambda: microbench_probe.main(["--table-mb", "0.1", "--reads", "8", "--reads-per-chunk", "8"]),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    mesh = parallel.make_block_mesh(device="cpu")
    assert mesh.device.type == "cpu" and parallel.make_mesh(device="cpu").size == 1
    assert distributed.initialize(device="cpu")["process_count"] == 1
    clf = parallel.BlockShardedClassifier(idx, mesh)
    hits = clf.count_hits_reads(np.zeros((3, 40), dtype=np.uint8), reads_per_chunk=4)
    assert hits.shape == (3, 2) and clf.table.device.type == "cpu"


def _small_model(tmp_path):
    idx = BlockedBitSlicedIndex.create(21, ["a", "b"], 1000, num_hashes=3)
    model = ProbabilisticFilterModel(21, "Tiny", None, None, "Species", tmp_path, device="cpu")
    model.index = idx
    model.display_names = {"a": "Tiny a", "b": "Tiny b"}
    return model


def test_ragged_input_and_unported_options_raise(tmp_path, data_root):
    """Ragged input classifies (the records route); validation is ported:
    where no group is flagged its result is the one without validation;
    the xxh3 genus filter is ported, an unknown hash family raises."""
    model = _small_model(tmp_path)
    ragged = tmp_path / "ragged.fasta"
    ragged.write_text(">r1\n" + "A" * 100 + "\n>r2\n" + "C" * 120 + "\n", encoding="utf-8")
    assert model.predict(ragged).num_kmers == {"r1": 80, "r2": 100}
    even = tmp_path / "even.fasta"
    even.write_text(">r1\n" + "A" * 100 + "\n>r2\n" + "C" * 100 + "\n", encoding="utf-8")
    validated = model.predict(even, validation=True)
    assert validated.misclassified is None
    assert json.dumps(validated.to_dict()) == json.dumps(model.predict(even).to_dict())
    assert set(model.predict(even).hits) == {"r1", "r2"}
    genus = ProbabilisticSingleFilterModel(
        21, "G", None, None, "Genus", tmp_path, hash_family="xxh3", device="cpu")
    assert genus.get_index_path().name == "filter.xxh3.npz"
    with pytest.raises(ValueError, match="unknown hash_family"):
        ProbabilisticSingleFilterModel(21, "G", None, None, "Genus", tmp_path, hash_family="murmur", device="cpu")


def test_saved_model_loads_back(tmp_path):
    model = _small_model(tmp_path)
    model.index.table[:] = np.arange(model.index.table.size, dtype=np.uint32)
    model.save()
    loaded = ProbabilisticFilterModel.load(tmp_path / "tiny-species.json", device="cpu")
    assert loaded.to_dict() == model.to_dict()
    np.testing.assert_array_equal(loaded.index.table, model.index.table)


def test_kernel_library_name_hashes_included_headers(tmp_path, monkeypatch):
    """An edited csrc header renames (so rebuilds) every library whose
    source includes it, and no other."""
    import shutil

    from xspect2_tpu_torch.ops import _kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    before = {name: _kernels.library_path(name) for name in _kernels.SIGNATURES}
    assert all((csrc / f"{name}.cu").exists() for name in _kernels.SIGNATURES)
    header = csrc / "kmer_probe.cuh"
    header.write_text(header.read_text(encoding="utf-8") + "\n// edited\n", encoding="utf-8")
    changed = {name for name in _kernels.SIGNATURES if _kernels.library_path(name) != before[name]}
    # K10 hashes its k-mers with the index's kmer_hash
    assert changed == {"reads_query", "records_query", "multi_records_query", "xxh3_bloom", "body_variants"}
    assert "probe_select" in _kernels.SIGNATURES
    before = {name: _kernels.library_path(name) for name in _kernels.SIGNATURES}
    header = csrc / "records_block.cuh"
    header.write_text(header.read_text(encoding="utf-8") + "\n// edited\n", encoding="utf-8")
    changed = {name for name in _kernels.SIGNATURES if _kernels.library_path(name) != before[name]}
    # K2 stages its codes as K3 and K5 do; K7 counts records with their block body
    assert changed == {"reads_query", "records_query", "multi_records_query", "xxh3_bloom"}
    before = {name: _kernels.library_path(name) for name in _kernels.SIGNATURES}
    header = csrc / "xxh3.cuh"
    header.write_text(header.read_text(encoding="utf-8") + "\n// edited\n", encoding="utf-8")
    changed = {name for name in _kernels.SIGNATURES if _kernels.library_path(name) != before[name]}
    assert changed == {"xxh3_bloom"}


def test_wire_kernels_hash_their_shared_header(tmp_path, monkeypatch):
    """``wire_tile.cuh`` renames K1's and K4's libraries and no other."""
    import shutil

    from xspect2_tpu_torch.ops import _kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    before = {name: _kernels.library_path(name) for name in _kernels.SIGNATURES}
    header = csrc / "wire_tile.cuh"
    header.write_text(header.read_text(encoding="utf-8") + "\n// edited\n", encoding="utf-8")
    changed = {name for name in _kernels.SIGNATURES if _kernels.library_path(name) != before[name]}
    assert changed == {"unpack_2bit", "records_wire"}


def test_wire_wrappers_launch_their_kernel_for_a_tensor_off_the_cpu(monkeypatch):
    """For a tensor that is not on the CPU (here on the ``meta`` device) K1
    and K4 launch their kernel, never their plain version: one launch for
    a patch list that ``upload_patch_list`` found ascending, a second
    (patch-only) one for any other, and the records path's restore is a
    K4 launch, never a K1 one."""
    import types

    from xspect2_tpu_torch.ops import _kernels, query

    calls = []

    def entry(name):
        return lambda *args: calls.append((name, args)) or 0

    def plain(*args, **kwargs):
        raise AssertionError("a wrapper fell back to its plain version")

    monkeypatch.setattr(_kernels, "entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for name in ("unpack_2bit_plain", "records_wire_plain", "restore_records_wire_plain"):
        monkeypatch.setattr(query, name, plain)
    meta = torch.device("meta")
    packed = torch.empty((64, 38), dtype=torch.uint8, device=meta)
    marked = query.upload_patch_list(np.arange(16, dtype=np.int32), meta)
    unmarked = torch.empty(16, dtype=torch.int32, device=meta)
    for ascending, launches in ((True, 1), (False, 2)):
        rows = marked if ascending else unmarked
        before = query.unpack_2bit.launches
        codes = query.unpack_2bit(packed, rows, rows, 150)
        assert codes.shape == (64, 150) and codes.device == meta
        assert query.unpack_2bit.launches - before == launches
        assert calls[-1][0] == "unpack_2bit" and calls[-1][1][-3:-1] == (16, int(ascending))
    flat = torch.empty(1000, dtype=torch.uint8, device=meta)
    offsets = torch.empty(9, dtype=torch.int32, device=meta)
    for ascending, launches in ((True, 1), (False, 2)):
        before = query.records_wire.launches, query.unpack_2bit.launches
        rows = marked if ascending else unmarked
        codes, rec, valid = query.restore_records_wire(flat, rows, offsets, 3980, k=21, step=2)
        assert (codes.shape, rec.shape, valid.shape) == ((4000,), (3980,), (3980,))
        assert (query.records_wire.launches - before[0], query.unpack_2bit.launches - before[1]) == (launches, 0)
        assert calls[-1][0] == "records_wire" and calls[-1][1][3:5] == (16, int(ascending))
    rec, valid = query.records_wire(offsets, 3980, k=21, step=2)
    assert calls[-1][0] == "records_wire" and calls[-1][1][0] is None and rec.shape == (3980,)
