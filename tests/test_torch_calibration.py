"""The port's ``recalibrate_constants`` tool and its synthetic index and reads.

``find_cliff`` and the constant arithmetic go against the JAX package's
``tools/recalibrate_constants.py`` (loaded from its file; it imports only
numpy at module level): both ``main``s run with their gather scan and
engine A/B replaced by the same measured numbers and must print the same
constant block, byte for byte.  ``tools/_synthetic.py`` goes against
``bench.build_or_load_index`` / ``simulate_reads`` (the bench's cache
directory moved to a temporary one): the same table and reads.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from xspect2_tpu_torch.tools import _synthetic, recalibrate_constants

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Every tensor here is tiny: one intra-op thread keeps the plain
    versions' many small ops from waiting on other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
FLAT = {25.0: 250e6, 50.0: 246e6, 75.0: 244e6, 100.0: 241e6}

# (gather rates by table MB, engine A/B {h: (reads/s, passes, MB)})
CASES = {
    "sharp_cliff": (
        {**FLAT, 110.0: 90e6, 120.0: 85e6, 150.0: 82e6, 200.0: 80e6},
        {2: (500_000.0, 4, 98.7), 7: (150_000.0, 11, 95.2)},
    ),
    "no_cliff": (
        {**FLAT, 110.0: 230e6, 120.0: 221e6, 150.0: 205e6, 200.0: 190e6},
        {2: (480_000.0, 4, 98.7), 7: (160_000.0, 11, 95.2)},
    ),
    "negative_t2": (
        {**FLAT, 110.0: 120e6, 120.0: 118e6, 150.0: 117e6, 200.0: 116e6},
        {2: (4_000_000.0, 4, 98.7), 7: (900_000.0, 11, 95.2)},
    ),
}


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_recalibrate_constants", ROOT / "tools" / "recalibrate_constants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert not {"jax", "xspect2_tpu"} & set(vars(module))  # numpy only at module level
    return module


@pytest.mark.parametrize("case", sorted(CASES))
def test_find_cliff_is_the_jax_tools(jax_tool, case):
    rates, _ = CASES[case]
    got = recalibrate_constants.find_cliff(rates)
    assert got == jax_tool.find_cliff(rates)
    assert (got[0] is None) == (case == "no_cliff")


@pytest.mark.parametrize("case", sorted(CASES))
def test_printed_constants_are_the_jax_tools_byte_for_byte(jax_tool, case, monkeypatch, capsys):
    rates, ab = CASES[case]
    monkeypatch.setattr(jax_tool, "gather_scan", lambda sizes, n, iters: dict(rates))
    monkeypatch.setattr(jax_tool, "engine_ab", lambda h_values: dict(ab))
    monkeypatch.setattr(sys, "argv", ["recalibrate_constants.py"])
    jax_tool.main()
    want = capsys.readouterr()

    monkeypatch.setattr(recalibrate_constants, "gather_scan", lambda *a: dict(rates))
    monkeypatch.setattr(recalibrate_constants, "engine_ab", lambda *a: dict(ab))
    assert recalibrate_constants.main(["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and want.out.startswith("\n=== pick_num_hashes constants for this chip ===\n")
    for line in ("no gather cliff found", "WARNING: engine time is smaller"):
        assert (line in got.err) == (line in want.err)
    c = recalibrate_constants.constants(rates, ab)
    assert recalibrate_constants.constant_block(c) == want.out
    assert (c["t2"] < 0) == (case == "negative_t2") and c["cliff"] == (case != "no_cliff")
    assert f"export XSPECT_FAST_TABLE_BYTES={c['budget_bytes']}\n" in got.out


def test_run_on_the_cpu_measures_and_prints_the_block(capsys, monkeypatch):
    engine_ab = recalibrate_constants.engine_ab
    monkeypatch.setattr(recalibrate_constants, "engine_ab", lambda *a: engine_ab(*a, reads_per_chunk=256))
    res = recalibrate_constants.run(sizes_mb=(0.05, 0.1), n=64, iters=1, device="cpu", classes=2,
                                    genome_mb=0.02, num_reads=256)
    assert set(res["rates"]) == {0.05, 0.1} and set(res["ab"]) == {2, 7}
    assert res["ab"][2][1] == 2 + min(2, 16) and res["ab"][7][1] == 7 + min(7, 16)  # P = 16 at 2 classes
    assert capsys.readouterr().out == res["block"]


@pytest.mark.parametrize("classes", [2, 40])
def test_synthetic_index_and_reads_are_the_benchs(classes, monkeypatch, tmp_path):
    """Field-packed (2 classes, P=16) and two class words (40 classes)."""
    monkeypatch.setattr(bench, "CACHE_DIR", tmp_path / "bench_cache")
    want, want_genomes = bench.build_or_load_index(classes, 0.05)
    got, genomes = _synthetic.build_index(classes, 0.05)
    np.testing.assert_array_equal(genomes, want_genomes)
    assert got.meta_dict() == want.meta_dict()
    assert np.asarray(got.table).tobytes() == np.asarray(want.table).tobytes()
    reads, cls = _synthetic.simulate_reads(genomes, 5000)
    want_reads, want_cls = bench.simulate_reads(want_genomes, 5000)
    np.testing.assert_array_equal(reads, want_reads)
    np.testing.assert_array_equal(cls, want_cls)
    assert (reads == 255).any()
    assert not list(ROOT.glob(f".bench_cache/*c{classes}_m0.05*"))
