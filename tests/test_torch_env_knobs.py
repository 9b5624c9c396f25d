"""The port honours the JAX package's three environment knobs.

- ``XSPECT_FAST_TABLE_BYTES``: the probe-count picker's budget, read at
  call time; with it set, both packages pick the same h and a filter fit
  writes the same ``.bbsi`` and metadata bytes.
- ``XSPECT_MODEL_CACHE``: how many loaded models the cache keeps, read
  at every ``load_cached`` call (0 or less: no caching; not a number: 3).
- ``XSPECT_NO_NATIVE``: no native host library, so a file of uniform
  reads takes the records route; the result JSON equals the JAX
  package's under the same variable.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from tests.conftest import random_dna
from xspect2_tpu import model_cache as jax_model_cache
from xspect2_tpu.core.blocked_index import pick_num_hashes as jax_pick_num_hashes
from xspect2_tpu.io.fasta import SeqRecord as JaxSeqRecord
from xspect2_tpu.io.fasta import write_fasta
from xspect2_tpu.models.filter_model import ProbabilisticFilterModel as JaxFilterModel
from xspect2_tpu_torch import model_cache
from xspect2_tpu_torch.core.blocked_index import pick_num_hashes
from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel

ROOT = Path(__file__).resolve().parent.parent


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


# ------------------------------------------------------------ XSPECT_FAST_TABLE_BYTES


@pytest.mark.parametrize("budget,h", [(None, 2), ("1", 7), ("70000000", 3), ("400000000", 2)])
def test_pick_num_hashes_follows_the_budget_variable(monkeypatch, budget, h):
    if budget is None:
        monkeypatch.delenv("XSPECT_FAST_TABLE_BYTES", raising=False)
    else:
        monkeypatch.setenv("XSPECT_FAST_TABLE_BYTES", budget)
    for num_kmers in (1_000, 4_000_000, 40_000_000, 400_000_000):
        for num_classes in (1, 3, 8, 40, 64):
            for fields_per_word in (None, 1):
                args = (num_kmers, 0.01, num_classes)
                kwargs = dict(fields_per_word=fields_per_word)
                assert pick_num_hashes(*args, **kwargs) == jax_pick_num_hashes(*args, **kwargs), (args, kwargs)
    # the 8-class 4 Mbp species geometry: h=2 (99 MB) in the default budget,
    # h=3 (65 MB) below 99 MB, h=7 (the smallest table) when every
    # candidate exceeds the budget
    assert pick_num_hashes(4_000_000, 0.01, 8) == h
    # an explicit budget wins over the variable
    assert pick_num_hashes(4_000_000, 0.01, 8, budget_bytes=108_000_000) == 2


def test_filter_fit_under_the_budget_variable_is_byte_identical(tmp_path, monkeypatch):
    rng = np.random.default_rng(57)
    cobs = tmp_path / "cobs"
    cobs.mkdir()
    for name in ("470", "471", "480"):
        write_fasta([JaxSeqRecord(random_dna(rng, 3000), id=name)], cobs / f"{name}.fasta")
    monkeypatch.setenv("XSPECT_FAST_TABLE_BYTES", "1")
    models = {}
    for cls, sub in ((JaxFilterModel, "jax"), (ProbabilisticFilterModel, "torch")):
        kwargs = {} if cls is JaxFilterModel else {"device": "cpu"}
        model = cls(21, "Synthetic", None, None, "Species", tmp_path / sub, **kwargs)
        model.fit(cobs)
        model.save()
        models[sub] = model
    assert models["torch"].num_hashes == models["jax"].num_hashes == 7
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    for rel in _files(tmp_path / "jax"):
        assert (tmp_path / "torch" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), str(rel)


# ------------------------------------------------------------ XSPECT_MODEL_CACHE


def _fake_model_class():
    """A model class whose ``load`` counts its calls and takes an optional
    device, as the JAX package's and the port's ``load`` do."""

    class Fake:
        loads = 0

        @classmethod
        def load(cls, path, device=None):
            cls.loads += 1
            return object()

    return Fake


@pytest.fixture()
def caches(tmp_path):
    """Both packages' caches, emptied, with a fake model class each and
    four metadata files."""
    jax_model_cache.clear()
    model_cache.clear()
    paths = []
    for i in range(4):
        p = tmp_path / f"m{i}.json"
        p.write_text("{}")
        paths.append(p)
    yield paths, _fake_model_class(), _fake_model_class()
    jax_model_cache.clear()
    model_cache.clear()


def _same_loads(caches, steps):
    """Each step (an index into the files) through the JAX package's
    ``load_cached`` and the port's: after every step both have loaded the
    same number of times, and each returned what a repeated step returns
    exactly when the other did."""
    paths, jax_cls, torch_cls = caches
    last = {}
    for i in steps:
        a = jax_model_cache.load_cached(jax_cls, paths[i])
        b = model_cache.load_cached(torch_cls, paths[i], "cpu")
        assert torch_cls.loads == jax_cls.loads, (steps, i)
        if i in last:
            assert (a is last[i][0]) == (b is last[i][1]), (steps, i)
        last[i] = (a, b)
    return jax_cls.loads


def test_cache_capacity_from_the_variable_evicts_the_oldest(caches, monkeypatch):
    monkeypatch.setenv("XSPECT_MODEL_CACHE", "2")
    # m0 is evicted at m2 (capacity 2); m2 and m1 stay; m0 loads again
    assert _same_loads(caches, [0, 1, 2, 2, 1, 0]) == 4
    # the device is part of the port's key (the JAX cache has none)
    paths, _, torch_cls = caches
    model_cache.load_cached(torch_cls, paths[0], "meta")
    assert torch_cls.loads == 5


def test_cache_disabled_by_the_variable(caches, monkeypatch):
    monkeypatch.setenv("XSPECT_MODEL_CACHE", "0")
    assert _same_loads(caches, [0, 0, 1, 0]) == 4


def test_cache_capacity_that_is_not_a_number_means_three(caches, monkeypatch):
    monkeypatch.setenv("XSPECT_MODEL_CACHE", "many")
    # the last three stay cached; the fourth evicted m0
    assert _same_loads(caches, [0, 1, 2, 3, 1, 2, 3, 0]) == 5


# ------------------------------------------------------------ XSPECT_NO_NATIVE

NO_NATIVE = textwrap.dedent(
    """
    import json, sys
    from pathlib import Path
    import xspect2_tpu.native as jax_native
    import xspect2_tpu_torch.native as native
    from xspect2_tpu.models.filter_model import ProbabilisticFilterModel as JaxFilterModel
    from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel

    meta, fastq, out = Path(sys.argv[1]), Path(sys.argv[2]), Path(sys.argv[3])
    report = {"available": native.available(), "jax_available": jax_native.available()}
    model = ProbabilisticFilterModel.load(meta, device="cpu")
    calls = {"records": 0}
    count_hits = model.engine.count_hits

    def records(batch):
        calls["records"] += 1
        return count_hits(batch)

    def reads(*args, **kwargs):
        raise AssertionError("the reads route ran")

    model.engine.count_hits = records
    model.engine.count_hits_reads = reads
    model.predict(fastq).save(out / "torch.json")
    JaxFilterModel.load(meta).predict(fastq).save(out / "jax.json")
    report.update(calls)
    print(json.dumps(report))
    """
)


def test_no_native_takes_the_records_route_with_the_jax_json(tmp_path):
    rng = np.random.default_rng(91)
    cobs = tmp_path / "cobs"
    cobs.mkdir()
    genomes = {name: random_dna(rng, 4000) for name in ("470", "471")}
    for name, seq in genomes.items():
        write_fasta([JaxSeqRecord(seq, id=name)], cobs / f"{name}.fasta")
    model = ProbabilisticFilterModel(21, "Synthetic", None, None, "Species", tmp_path / "model", device="cpu")
    model.fit(cobs)
    model.save()
    (meta,) = (tmp_path / "model").glob("*.json")
    lines = []
    for i in range(600):  # >= 512 reads of one length: the reads route when native is on
        g = genomes["470" if i % 2 else "471"]
        s = int(rng.integers(0, len(g) - 150))
        lines += [f"@read{i}", g[s : s + 150], "+", "I" * 150]
    fastq = tmp_path / "reads.fastq"
    fastq.write_text("\n".join(lines) + "\n", encoding="utf-8")
    env = dict(os.environ, XSPECT_NO_NATIVE="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    out = subprocess.run(
        [sys.executable, "-c", NO_NATIVE, str(meta), str(fastq), str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report == {"available": False, "jax_available": False, "records": 1}
    got, want = (tmp_path / "torch.json").read_bytes(), (tmp_path / "jax.json").read_bytes()
    assert got == want
    assert len(json.loads(got)["hits"]) == 600
