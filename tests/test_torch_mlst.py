"""The port's MLST path equals the JAX package's.

The multi-index query with its on-device reductions goes against
``xspect2_tpu.ops.query.make_multi_packed_query`` (JAX on the CPU) on
one index set built by the JAX ``BlockedBitSlicedIndex``; a synthetic
three-locus scheme (4, 40 and 6 alleles, so one locus has two class
words and one has its own allele length) is trained by both packages,
and the same numpy-seeded genomes go through ``calculate_hits``,
``predict`` and ``classify_mlst`` of both.  The port runs on
``device="cpu"`` through its kernels' plain versions.  The ST-name
lookup (a network call) is replaced in both.  Every comparison is exact.
"""

import json

import numpy as np
import pytest
import torch

from tests.conftest import random_dna
from tests.test_torch_query import _genomes, _jax_index
from xspect2_tpu.io.fasta import SeqRecord as JaxSeqRecord
from xspect2_tpu.io.fasta import write_fasta
from xspect2_tpu.models import mlst_model as jax_mlst
from xspect2_tpu.ops import query as jax_query
from xspect2_tpu_torch import convert
from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.models import mlst_model as port_mlst
from xspect2_tpu_torch.ops import query

K = 31
LOCI = {"Oxf_cpn60": (4, 450), "Oxf_gltA": (40, 450), "Oxf_rpoB": (6, 300)}
MODEL_ARGS = ("Oxford", "https://example.org/schemes/1", "abaumannii")


# ---------------------------------------------------------------- the multi-index query


@pytest.fixture(scope="module")
def index_set():
    """Three JAX-built indices (field-packed C=4, C=40 with two class
    words, C=8) carried across, and records drawn from their genomes."""
    rng = np.random.default_rng(31)
    pairs, genomes = [], []
    for num_classes, h in ((4, 2), (40, 3), (8, 1)):
        g = _genomes(rng, num_classes, 1500)
        jidx = _jax_index(g, 21, h)
        pairs.append((jidx, convert.index_from_arrays(jidx.meta_dict(), jidx.table)))
        genomes += g[:2]
    records = []
    for i in range(13):
        g = genomes[i % len(genomes)]
        n = 22 if i == 0 else int(rng.integers(60, 700))
        s = int(rng.integers(0, len(g) - n))
        c = g[s : s + n].copy()
        if i % 4 == 0:
            c[int(rng.integers(0, n))] = 255
        records.append((f"r{i}", c))
    return pairs, records


def _wire(records, chunk=1024):
    batch = query.prepare_batch(records, 21, chunk=chunk)
    max_records = query._next_pow2(max(8, batch.num_records))
    return batch, max_records, query.packed_wire_for_batch(batch, max_records)


def _jax_geoms(pairs, batch, max_records, chunk=1024):
    return tuple(
        tuple(sorted(dict(
            num_blocks=int(j.num_blocks), k=21, num_hashes=j.num_hashes,
            rows_per_block=j.rows_per_block, class_words=j.class_words,
            num_classes=j.num_classes, chunk=chunk, num_chunks=batch.num_positions // chunk,
            max_records=max_records, fields_per_word=j.fields_per_word,
        ).items()))
        for j, _ in pairs
    )


@pytest.mark.parametrize(
    "mode,threshold",
    [(None, 0), ("thresholded_totals", 50), ("first_record", 0),
     ("thresholded_segment_totals", 50), ("thresholded_segment_totals", -1)],
)
def test_multi_packed_query_matches_jax(index_set, mode, threshold):
    import jax.numpy as jnp

    pairs, records = index_set
    assert [j.class_words for j, _ in pairs] == [1, 2, 1]
    batch, max_records, wire = _wire(records)
    seg = np.zeros(max_records, dtype=np.int32)
    seg[: len(records)] = np.arange(len(records)) // 5
    segmented = mode == "thresholded_segment_totals"
    jax_fn = jax_query.make_multi_packed_query(
        _jax_geoms(pairs, batch, max_records), 1, reduce_mode=mode, threshold=threshold,
        num_segments=3 if segmented else None,
    )
    jax_args = [tuple(jnp.asarray(j.device_table()) for j, _ in pairs), *map(jnp.asarray, wire)]
    want = jax_fn(*jax_args, jnp.asarray(seg)) if segmented else jax_fn(*jax_args)

    engines = [query.DeviceQueryEngine(p, device="cpu") for _, p in pairs]
    fn = query.make_multi_packed_query(
        [e.geometry() for e in engines], 1, batch.num_positions, reduce_mode=mode,
        threshold=threshold, num_segments=3 if segmented else None,
    )
    got = fn([e.table for e in engines], *map(torch.from_numpy, wire),
             torch.from_numpy(seg) if segmented else None)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if mode is None:  # and the host reference
        for (_, p), g in zip(pairs, got):
            host = np.stack([p.count_hits_host(*dna.canonical_kmers(c, 21)) for _, c in records])
            np.testing.assert_array_equal(g.numpy()[: len(records)], host)


def test_segment_ids_outside_the_range_add_nothing(index_set):
    """As ``jax.ops.segment_sum`` drops them."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    counts = rng.integers(0, 120, size=(16, 40), dtype=np.int32)
    seg = rng.integers(0, 3, size=16).astype(np.int32)
    seg[[2, 9]] = [-1, 3]
    want = jax.ops.segment_sum(jnp.where(counts > 50, counts, 0), jnp.asarray(seg), num_segments=3)
    (got,) = query.reduce_record_counts(
        [torch.from_numpy(counts)], "thresholded_segment_totals", 50, torch.from_numpy(seg), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_multi_query_argument_checks(index_set):
    pairs, records = index_set
    engines = [query.DeviceQueryEngine(p, device="cpu") for _, p in pairs]
    geoms = [e.geometry() for e in engines]
    for bad in (None, 0, -2):
        with pytest.raises(ValueError, match="num_segments >= 1"):
            query.make_multi_packed_query(geoms, 1, 1024, "thresholded_segment_totals", num_segments=bad)
    with pytest.raises(ValueError, match="unknown reduce mode"):
        query.make_multi_packed_query(geoms, 1, 1024, "totals")
    too_many = query.MAX_TABLES + 1
    batch, max_records, wire = _wire(records)
    with pytest.raises(ValueError, match=f"1 to {query.MAX_TABLES} tables"):
        query.make_multi_packed_query(geoms[:1] * too_many, 1, batch.num_positions)(
            [engines[0].table] * too_many, *map(torch.from_numpy, wire))
    inputs = [torch.from_numpy(a) for a in (batch.codes, batch.rec_ids, batch.valid)]
    with pytest.raises(ValueError, match=f"1 to {query.MAX_TABLES} tables"):
        query.multi_records_query(
            [engines[0].table] * too_many, geoms[:1] * too_many, *inputs, max_records=max_records)
    with pytest.raises(ValueError, match="share k"):
        query.multi_records_query(
            [e.table for e in engines[:2]], [geoms[0], dict(geoms[1], k=19)], *inputs,
            max_records=max_records)
    with pytest.raises(ValueError, match="equal length"):
        query.multi_records_query([engines[0].table], geoms[:2], *inputs, max_records=max_records)
    counts = [torch.zeros((8, 4), dtype=torch.int32)]
    with pytest.raises(ValueError, match=f"1 to {query.MAX_TABLES} count tensors"):
        query.reduce_record_counts(counts * too_many, "first_record")
    with pytest.raises(ValueError, match="seg_ids"):
        query.reduce_record_counts(counts, "thresholded_segment_totals", 0, torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="2-D int32"):
        query.reduce_record_counts([counts[0].long()], "first_record")


# ---------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def scheme(tmp_path_factory):
    """The scheme as ``Allele_ID_<n>.fasta`` files, its alleles, and a
    model of each package trained on it."""
    root = tmp_path_factory.mktemp("mlst")
    rng = np.random.default_rng(12345)
    alleles = {}
    for locus, (count, length) in LOCI.items():
        (root / "scheme" / locus).mkdir(parents=True)
        base = random_dna(rng, length)
        for n in range(1, count + 1):
            variant = list(base)
            for _ in range(n * 3):
                variant[int(rng.integers(0, length))] = "ACGT"[int(rng.integers(0, 4))]
            alleles[(locus, n)] = "".join(variant)
            write_fasta(
                [JaxSeqRecord(alleles[(locus, n)], id=f"{locus}_{n}")],
                root / "scheme" / locus / f"Allele_ID_{n}.fasta",
            )
    (root / "jax").mkdir()
    (root / "port").mkdir()
    name, url, organism = MODEL_ARGS
    jax_model = jax_mlst.ProbabilisticFilterMlstSchemeModel(K, name, root / "jax", url, organism)
    jax_model.fit(root / "scheme")
    jax_model.save()
    model = port_mlst.ProbabilisticFilterMlstSchemeModel(K, name, root / "port", url, organism, device="cpu")
    model.fit(root / "scheme")
    model.save()
    return root, alleles, jax_model, model


@pytest.fixture()
def no_lookup(monkeypatch):
    """The ST-name lookup is a network call: both packages answer alike."""
    for module in (jax_mlst, port_mlst):
        monkeypatch.setattr(
            module.ProbabilisticFilterMlstSchemeModel, "_resolve_strain_type",
            lambda self, highest: "ST-" + "-".join(
                next(iter(v)).split("_")[-1] for v in highest.values() if isinstance(v, dict)),
        )


def _genome(rng, alleles, length):
    """A random genome with one allele of every locus embedded; returns
    the sequence and the alleles picked."""
    seq = random_dna(rng, length)
    pos, picks = 2_000, {}
    for locus, (count, _) in LOCI.items():
        picks[locus] = int(rng.integers(1, count + 1))
        allele = alleles[(locus, picks[locus])]
        seq = seq[:pos] + allele + seq[pos + len(allele) :]
        pos += 8_000
    return seq, picks


def _inputs(alleles):
    rng = np.random.default_rng(99)
    long = [_genome(rng, alleles, 25_000) for _ in range(3)]
    seqs = {f"long{i}": s for i, (s, _) in enumerate(long)}
    seqs["short0"] = alleles[("Oxf_gltA", 7)] + random_dna(rng, 300)
    seqs["short1"] = random_dna(rng, 900)
    seqs["long3"] = _genome(rng, alleles, 12_000)[0] + "N" * 40 + random_dna(rng, 500)
    return seqs, {f"long{i}": p for i, (_, p) in enumerate(long)}


def test_fit_writes_identical_files_and_models_load_across(scheme):
    root, _, jax_model, model = scheme
    jax_files = sorted(p.relative_to(root / "jax") for p in (root / "jax").rglob("*") if p.is_file())
    port_files = sorted(p.relative_to(root / "port") for p in (root / "port").rglob("*") if p.is_file())
    assert jax_files == port_files and len(jax_files) == 1 + 2 * len(LOCI)
    for rel in jax_files:
        assert (root / "jax" / rel).read_bytes() == (root / "port" / rel).read_bytes(), rel
    assert model.to_dict() == jax_model.to_dict()
    assert [i.class_words for i in model.indices] == [1, 2, 1]
    assert model.avg_locus_bp_size == [450, 450, 300]

    slug = "abaumannii-oxford-mlst.json"
    from_jax = port_mlst.ProbabilisticFilterMlstSchemeModel.load(root / "jax" / slug, device="cpu")
    from_port = jax_mlst.ProbabilisticFilterMlstSchemeModel.load(root / "port" / slug)
    assert from_jax.to_dict() == from_port.to_dict() == model.to_dict()
    for a, b, c in zip(from_jax.indices, from_port.indices, model.indices):
        np.testing.assert_array_equal(a.table, c.table)
        np.testing.assert_array_equal(np.asarray(b.table), c.table)
    carried = convert.mlst_model_from_arrays(
        jax_model.to_dict(), [(i.meta_dict(), i.table) for i in jax_model.indices],
        root / "port", device="cpu")
    assert carried.to_dict() == model.to_dict()
    assert carried.calculate_hits("ACGT" * 100)[1] == model.calculate_hits("ACGT" * 100)[1]


@pytest.mark.parametrize("name", ["long0", "short0", "short1", "long3"])
@pytest.mark.parametrize("limit", [False, True])
def test_calculate_hits_matches_jax(scheme, no_lookup, name, limit):
    _, alleles, jax_model, model = scheme
    seqs, picks = _inputs(alleles)
    got = model.calculate_hits(seqs[name], limit=limit)
    want = jax_model.calculate_hits(seqs[name], limit=limit)
    assert json.dumps(got) == json.dumps(want)
    strain = got[0]["Strain type"]
    for locus, allele in picks.get(name, {}).items():
        assert next(iter(strain[locus])) == f"Allele_ID_{allele}"
    if name == "short0":
        assert strain["Oxf_gltA"]["Allele_ID_7"] >= 450 - K + 1  # every window of the allele
    if name == "short1":
        assert "Attention:" in strain and "ST_Name" not in strain
    if limit:
        assert all(len(v) <= 5 for v in got[1]["All results"].values())


def test_mlst_model_path_is_the_jax_path(data_root):
    from xspect2_tpu.model_management import get_mlst_model_path as jax_path
    from xspect2_tpu_torch.model_management import get_mlst_model_path

    assert get_mlst_model_path("A. baumannii", "Oxford") == jax_path("A. baumannii", "Oxford")
    assert get_mlst_model_path("a", "b").name == "a-b-mlst.json"


def test_mlst_error_cases(scheme, tmp_path):
    _, _, _, model = scheme
    with pytest.raises(ValueError, match="longer than k"):
        model.calculate_hits("A" * K)
    with pytest.raises(ValueError, match="must be a string"):
        model._dispatch_loci(b"ACGT" * 20, 1)
    with pytest.raises(ValueError, match="split status"):
        model._dispatch_loci_group(["A" * 12_000, "A" * 900], 1)
    name, url, organism = MODEL_ARGS
    empty = port_mlst.ProbabilisticFilterMlstSchemeModel(K, name, tmp_path, url, organism, device="cpu")
    with pytest.raises(ValueError, match="not been trained"):
        empty.calculate_hits("A" * 100)
    with pytest.raises(ValueError, match="Scheme not found"):
        empty.fit(tmp_path / "nowhere")
    with pytest.raises(FileNotFoundError):
        port_mlst.ProbabilisticFilterMlstSchemeModel.load(tmp_path / "none.json", device="cpu")


def test_sequence_splitter_and_sufficiency_match_jax(scheme):
    _, _, jax_model, model = scheme
    for length, allele_len in ((25_000, 450), (10_030, 300), (1_000_500, 450)):
        seq = "ACGT" * (length // 4)
        assert model.sequence_splitter(seq, allele_len) == jax_model.sequence_splitter(seq, allele_len)
    sizes = [450, 450]
    assert model.has_sufficient_score({"a": {"x": 300}, "b": {"y": 10}}, sizes)
    assert not model.has_sufficient_score({"a": {"x": 100}, "b": {"y": 10}}, sizes)
    assert not model.has_sufficient_score({"a": {}, "b": {}}, sizes)


def test_offline_lookup_gives_the_na_string(scheme, monkeypatch):
    """Without ``requests`` the lookup's failure becomes the ST name."""
    import sys

    _, alleles, _, model = scheme
    monkeypatch.setitem(sys.modules, "requests", None)
    monkeypatch.delitem(sys.modules, "xspect2_tpu_torch.handlers.http", raising=False)
    monkeypatch.delitem(sys.modules, "xspect2_tpu_torch.handlers.pubmlst", raising=False)
    strain = model.calculate_hits(alleles[("Oxf_gltA", 3)])[0]["Strain type"]
    assert strain["ST_Name"].startswith("N/A (PubMLST lookup failed: ")
