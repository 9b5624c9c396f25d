"""The port's profiling phases and trace agree with the JAX package's.

The pure-Python timers take the same calls and report the same phases
and counts; the engines of both packages record ``query.pack``,
``query.dispatch`` and ``query.sync`` at the same places, the same
number of times; and ``trace`` writes a ``torch.profiler`` trace."""

import json

import numpy as np
import pytest

from tests.test_torch_query import _genomes, _jax_index
from xspect2_tpu import profiling as jax_profiling
from xspect2_tpu.ops import query as jax_query
from xspect2_tpu_torch import convert, profiling
from xspect2_tpu_torch.ops import query


@pytest.fixture(autouse=True)
def _clean_phases():
    jax_profiling.reset()
    profiling.reset()
    yield
    jax_profiling.reset()
    profiling.reset()


def _calls(mod):
    with mod.phase("parse"):
        pass
    for _ in range(3):
        with mod.phase("query.dispatch"):
            pass
    mod.add("svm", 0.25)
    mod.add("svm", 0.5)
    with pytest.raises(ValueError):
        with mod.phase("fails"):
            raise ValueError("a failing phase is still timed")
    return mod.report()


def _counts(report):
    return {name: entry["calls"] for name, entry in report.items()}


def test_phase_add_reset_report_agree_with_jax():
    want, got = _calls(jax_profiling), _calls(profiling)
    assert list(got) == list(want) == ["fails", "parse", "query.dispatch", "svm"]
    assert _counts(got) == _counts(want) == {"fails": 1, "parse": 1, "query.dispatch": 3, "svm": 2}
    assert got["svm"]["seconds"] == want["svm"]["seconds"] == 0.75
    assert set(json.loads(profiling.report_json())) == set(got)
    assert json.loads(profiling.report_json())["svm"] == {"seconds": 0.75, "calls": 2}
    profiling.reset()
    jax_profiling.reset()
    assert profiling.report() == jax_profiling.report() == {}
    assert profiling.report_json() == jax_profiling.report_json() == "{}"


def test_engine_phases_match_jax_names_and_counts():
    """``count_hits_reads`` (twice) and ``count_hits`` (twice on one batch:
    the wire is packed once) record the same phases, the same number of
    times, in both packages."""
    rng = np.random.default_rng(7)
    genomes = _genomes(rng, 4, 2500)
    jidx = _jax_index(genomes, 21, 2)
    idx = convert.index_from_arrays(jidx.meta_dict(), jidx.table)
    engines = (jax_query.DeviceQueryEngine(jidx), query.DeviceQueryEngine(idx, device="cpu"))
    reads = rng.integers(0, 4, size=(40, 100), dtype=np.uint8)
    reads[3, 7] = 255
    records = [(f"r{i}", genomes[i % 4][i * 50 : i * 50 + 300]) for i in range(5)]
    reports, hits = [], []
    for mod, engine, q in zip((jax_profiling, profiling), engines, (jax_query, query)):
        mod.reset()
        out = [engine.count_hits_reads(reads, reads_per_chunk=16) for _ in range(2)]
        batch = q.prepare_batch(records, 21, step=2, chunk=engine.chunk)
        out += [engine.count_hits(batch) for _ in range(2)]
        hits.append(out)
        reports.append(mod.report())
    for want, got in zip(*hits):
        np.testing.assert_array_equal(got, want)
    assert _counts(reports[1]) == _counts(reports[0])
    assert _counts(reports[1]) == {"query.dispatch": 2, "query.pack": 3, "query.sync": 2}


def test_trace_writes_a_torch_profiler_trace_on_the_cpu(tmp_path):
    import torch

    with profiling.trace(tmp_path / "trace"):
        with profiling.phase("work"):
            torch.arange(1000).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert profiling.report()["work"]["calls"] == 1
