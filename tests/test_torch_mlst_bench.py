"""The benchmark's MLST cell (``mlst7-genomes``) on the CPU, at tiny size.

The port's ``classify_mlst`` against the plain reference
(``bench_port/reference_mlst.py``) on a seeded scheme served by the
loopback designations service (``bench_port/mlst_service.py``): every
branch of the typing (split and whole records, reliable and unreliable
types, a type the profile table holds and one it lacks, a locus without
a call, a record without any).  Then the harness's run of the tiny cell,
the check's control and two planted faults, and the imports of the
reference and the service.
"""

import gc
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import control, harness, mlst_service, reference_mlst, synthetic
from bench_port.harness import PoolFile
from bench_port.tests import tiny_mlst
from xspect2_tpu_torch import classify, model_cache
from xspect2_tpu_torch.models.mlst_model import ProbabilisticFilterMlstSchemeModel

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _records(scheme, genomes, rng) -> list:
    """Records through every branch of the typing: ``[(id, codes)]``."""
    loci = list(scheme.loci)

    def carrying(profile, flank):
        parts = [rng.integers(0, 4, size=flank, dtype=np.uint8)]
        for locus, n in zip(loci, profile):
            parts += [scheme.loci[locus][n - 1], rng.integers(0, 4, size=flank, dtype=np.uint8)]
        return np.concatenate(parts)

    known = next(iter(scheme.profiles))
    novel = known
    while novel in scheme.profiles:
        novel = tuple(int(a) for a in rng.integers(1, len(scheme.loci[loci[0]]) + 1, size=len(loci)))
    return [
        ("known_whole", carrying(known, 900)),
        ("novel_whole", carrying(novel, 900)),
        ("genome0", genomes[0]),
        ("genome1", genomes[1]),
        ("one_locus_split", np.concatenate([rng.integers(0, 4, size=6_000, dtype=np.uint8),
                                            scheme.loci[loci[0]][known[0] - 1],
                                            rng.integers(0, 4, size=6_000, dtype=np.uint8)])),
        ("random_split", rng.integers(0, 4, size=12_000, dtype=np.uint8)),
        ("random_whole", rng.integers(0, 4, size=2_000, dtype=np.uint8)),
    ]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The tiny scheme, trained through the port on the CPU, its service
    running, and a FASTA file of :func:`_records`."""
    root = tmp_path_factory.mktemp("mlst-bench")
    plan = tiny_mlst.plan()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XSPECT_DATA_ROOT", str(root / "xspect-data"))
        genomes, scheme, train_fn = plan["kind"].make_training(plan["config"], np.random.default_rng(7),
                                                               root / "train")
        train_fn("cpu")
        records = _records(scheme, genomes, np.random.default_rng(8))
        synthetic.write_fasta(root / "typed.fasta", records)
        yield plan, scheme, records, root
    model_cache.clear()


def _classify(plan, root, out):
    classify.classify_mlst(root / "typed.fasta", plan["config"]["organism"], plan["config"]["scheme"], out,
                           False, device="cpu")
    return json.loads(out.read_text(encoding="utf-8"))


def test_classify_mlst_writes_the_reference_json(trained, tmp_path, monkeypatch):
    plan, scheme, records, root = trained
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(root / "xspect-data"))
    got = _classify(plan, root, tmp_path / "out.json")
    ref = plan["kind"].reference(plan, scheme, "cpu")
    pf = PoolFile(root / "typed.fasta", [r for r, _ in records], [len(c) for _, c in records], 0,
                  [c for _, c in records])
    want, decisions = ref.answers(pf, 1)
    assert decisions is None
    assert json.dumps(got) == json.dumps(want)
    assert ref.differences(got, want) == []
    calls = {rid: parts[0]["Strain type"] for rid, parts in want["Results"].items()}
    assert calls["known_whole"]["ST_Name"] == {"ST": scheme.profiles[next(iter(scheme.profiles))]}
    assert calls["novel_whole"]["ST_Name"] == reference_mlst.NOVEL
    assert "ST_Name" in calls["genome0"]
    assert calls["one_locus_split"]["ST_Name"].startswith("N/A (PubMLST lookup failed: ")
    assert calls["random_split"]["Attention:"] == reference_mlst.UNRELIABLE
    assert want["Results"]["random_split"][1]["All results"] == reference_mlst.NO_MATCHES
    assert calls["random_whole"]["Attention:"] == reference_mlst.UNRELIABLE
    # a whole record lists every allele; a split one only those counted
    alleles = len(scheme.loci["Oxf_cpn60"])
    assert len(want["Results"]["random_whole"][1]["All results"]["Oxf_cpn60"]) == alleles
    assert 0 < len(want["Results"]["genome0"][1]["All results"]["Oxf_cpn60"]) <= alleles


def test_the_service_answers_from_the_profile_table(trained):
    plan, scheme, _, root = trained
    service = scheme.keep[0]
    loci = list(scheme.loci)
    known, st = next(iter(scheme.profiles.items()))
    post = ProbabilisticFilterMlstSchemeModel(31, "Oxford", root, f"{service.url}/db/x/schemes/1", "x",
                                              device="cpu")
    assert post._resolve_strain_type({locus: {f"Allele_ID_{n}": 1} for locus, n in zip(loci, known)}) == {"ST": st}
    off = (known[0] % len(scheme.loci[loci[0]]) + 1, *known[1:])
    assert (off in scheme.profiles) or post._resolve_strain_type(
        {locus: {f"Allele_ID_{n}": 1} for locus, n in zip(loci, off)}) == reference_mlst.NOVEL
    assert mlst_service.read_profiles(root / "train" / "profiles.tsv") == (loci, scheme.profiles)


def test_a_tiny_run_of_the_cell_is_correct(tmp_path, monkeypatch):
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "unused"))
    res = tiny_mlst.run(tmp_path=tmp_path)
    assert res["correct"] and res["failed"] == 0 and res["checks"]["wrong_answers"]["value"] == 0
    assert set(res["metrics"]) == {"assemblies_per_s", "setup_s"}


def test_the_control_fails_the_check_and_the_program_passes(tmp_path, monkeypatch):
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "unused"))
    got = control.readings(tiny_mlst.plan(), tiny_mlst.SEED, 0.3, "cpu", work_root=tmp_path)
    assert got["program"]["correct"] and got["program"]["wrong_answers"] == 0
    # no probe at one hash: every k-mer a member of every allele
    assert not got["control"]["correct"] and got["control"]["wrong_answers"] > 0
    assert "head_gap" not in got["program"] and "head_float32" not in got


def _count_off_by_one(counts):
    counts = [c.copy() for c in counts]
    counts[0].flat[0] += 1
    return counts


@pytest.mark.parametrize("fault", ["count_off_by_one", "wrong_st_name"])
def test_a_planted_fault_is_not_correct(tmp_path, monkeypatch, fault):
    monkeypatch.setenv("XSPECT_DATA_ROOT", str(tmp_path / "unused"))
    if fault == "count_off_by_one":
        inner = ProbabilisticFilterMlstSchemeModel._fetch_counts
        monkeypatch.setattr(ProbabilisticFilterMlstSchemeModel, "_fetch_counts",
                            staticmethod(lambda dispatched: _count_off_by_one(inner(dispatched))))
    else:
        monkeypatch.setattr(ProbabilisticFilterMlstSchemeModel, "_resolve_strain_type",
                            lambda self, calls: {"ST": "0"})
    res = tiny_mlst.run(tmp_path=tmp_path)
    assert not res["correct"] and res["checks"]["wrong_answers"]["value"] > 0


_PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from bench_port import mlst_service, reference_mlst, roofline_mlst
print(sorted(m for m in sys.modules if m.split(".", 1)[0] in ("jax", "jaxlib", "xspect2_tpu", "xspect2_tpu_torch")))
"""


def test_the_reference_and_the_service_import_neither_jax_nor_the_port(tmp_path):
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_service_stops_with_its_owner(tmp_path):
    mlst_service.write_profiles(tmp_path / "p.tsv", ["a", "b"], {(1, 2): "5"})
    service = mlst_service.Service(tmp_path / "p.tsv")
    proc = service._proc
    assert proc.poll() is None
    del service
    gc.collect()
    assert proc.wait(timeout=10) == 0


def test_the_k5_and_k6_bounds_by_hand():
    """A 5,000-base record (one piece) against one locus of 40 alleles of
    100 bases: cw 2, 64 rows of 8 B a block, one probe a k-mer."""
    import math

    from bench_port import roofline_mlst
    from bench_port.reference_mlst import Scheme

    rng = np.random.default_rng(5)
    config = {"k": 31, "fpr": 0.001, "num_hashes": 1, "fields_per_word": 1, "block_bytes": 512, "oversize": 1.3,
              "sizing": "per_class"}
    scheme = Scheme({"Oxf_a": [rng.integers(0, 4, size=100, dtype=np.uint8) for _ in range(40)]}, {})
    geoms = roofline_mlst.locus_geometries(config, scheme)
    bits = math.ceil(-70 / math.log(1 - 0.001))
    blocks = max(16, -(-bits // 64))
    assert geoms["Oxf_a"]["num_blocks"] == blocks and geoms["Oxf_a"]["rows_per_block"] == 64
    codes = rng.integers(0, 4, size=5_000, dtype=np.uint8)
    counted = 5_000 - 30
    rows = blocks * 64
    k5_bytes = 5_000 + 4 * 2 + rows * -math.expm1(-counted / rows) * 8 + 4 * 40
    k5_ops = counted * (90 + 10 + 3 * 2)
    k6_bytes, k6_ops = 4 + 4 * 40 + 4 * 40, 2 * 40
    got = roofline_mlst.record_bounds(config, scheme, geoms, codes, 1)
    assert got[roofline_mlst.K5] == pytest.approx(max(k5_bytes / 3.35e12, k5_ops / 67e12), rel=1e-12)
    assert got[roofline_mlst.K6] == pytest.approx(max(k6_bytes / 3.35e12, k6_ops / 67e12), rel=1e-12)


def test_loci_of_one_length_share_the_window_work():
    """Two loci of one allele length are one group: the pieces' bases and
    k-mer windows count once, each table's rows and counts once each."""
    import math

    from bench_port import roofline, roofline_mlst
    from bench_port.reference_mlst import Scheme, split_pieces

    rng = np.random.default_rng(6)
    config = {"k": 31, "fpr": 0.001, "num_hashes": 1, "fields_per_word": 1, "block_bytes": 512, "oversize": 1.3,
              "sizing": "per_class"}
    alleles = [rng.integers(0, 4, size=120, dtype=np.uint8) for _ in range(40)]
    one = Scheme({"Oxf_a": alleles}, {})
    two = Scheme({"Oxf_a": alleles, "Oxf_b": alleles}, {})
    codes = rng.integers(0, 4, size=30_000, dtype=np.uint8)
    pieces = split_pieces(codes, 120, 31)
    # starts 0, 90, ..., 29,880; the 30-base tail (under k) joins the last piece
    assert len(pieces) == 333 and sum(len(p) for p in pieces) == 333 * 120 + 30
    counted = roofline.counted_kmers(pieces, 31, 1)
    b1 = roofline_mlst.record_bounds(config, one, roofline_mlst.locus_geometries(config, one), codes, 1)
    b2 = roofline_mlst.record_bounds(config, two, roofline_mlst.locus_geometries(config, two), codes, 1)
    geom = roofline_mlst.locus_geometries(config, one)["Oxf_a"]
    rows = geom["num_blocks"] * geom["rows_per_block"]
    table = rows * -math.expm1(-counted / rows) * 8 + 4 * len(pieces) * 40
    shared = 333 * 120 + 30 + 4 * (len(pieces) + 1)
    # the second table adds its rows, counts and probes, not the bases or windows
    assert b1[roofline_mlst.K5] == pytest.approx(max((shared + table) / 3.35e12,
                                                     counted * (90 + 10 + 6) / 67e12), rel=1e-12)
    assert b2[roofline_mlst.K5] == pytest.approx(max((shared + 2 * table) / 3.35e12,
                                                     counted * (90 + 2 * (10 + 6)) / 67e12), rel=1e-12)
    assert b2[roofline_mlst.K6] == pytest.approx(2 * b1[roofline_mlst.K6] - 4 * len(pieces) / 3.35e12, rel=1e-12)


@pytest.mark.parametrize("name,kernel", [("k5_roofline.assemblies", "multi_records_query_kernel"),
                                         ("k6_roofline.assemblies", "segment_reduce_kernel")])
def test_a_kernel_share_is_its_bound_over_its_device_time(name, kernel):
    from bench_port.measure import Run
    from bench_port.tracing import TraceSummary

    trace = TraceSummary(window_s=51.0, busy_s=1.0, device_ops={f"{kernel}<1>": 0.003, f"{kernel}<2>": 0.001,
                                                                "records_wire_kernel": 0.5})
    run = Run(setup_s=1.0, window_s=51.0, requests=[], work={"assemblies": 10}, trace=trace,
              bounds={kernel: 0.001})
    assert harness.read_metric(name, run) == pytest.approx(25.0)
    assert harness.read_metric(name, Run(setup_s=1.0, window_s=51.0, requests=[], work={})) is None
