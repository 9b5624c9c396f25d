"""The records route of a FASTA file, built from the file's one native parse.

``predict`` parses a file natively once.  A FASTA file that takes the
records route cuts its batches from that parse, unless a scan of its
bytes finds something on which the parse could differ from the line
reader (``io/fasta.py``), which then serves it.  Each file below is
classified through the facade, as it routes itself and, where that is
the parse, once more with the reader forced; the result JSON, or the
error raised, must be the same, and the counters
``wire.records_from_parse`` / ``wire.records_from_reader`` must name
the route the file took.  There the engine's counts are stood in for by
counts made from each batch's own codes, so that the comparison covers
everything the two routes build on the host (ids, codes, offsets,
batches, k-mer counts) at a fraction of the plain query's cost; the
engine itself runs where the assemblies from the parse are held against
the JAX package's result JSON.  ``batch_from_flat`` and the lazy
record ids and validity are held against the JAX package's
``prepare_batch``.
"""

import numpy as np
import pytest
import torch

from xspect2_tpu import classify as jax_classify
from xspect2_tpu import model_cache as jax_model_cache
from xspect2_tpu.ops import query as jax_query
from xspect2_tpu_torch import classify, model_cache, native, profiling
from xspect2_tpu_torch.io.fasta import get_record_iterator
from xspect2_tpu_torch.models import filter_model
from xspect2_tpu_torch.ops import query

K = 21
PARSE, READER = "wire.records_from_parse", "wire.records_from_reader"


@pytest.fixture()
def clean(session_data_root):
    jax_model_cache.clear()
    model_cache.clear()
    profiling.reset()
    yield session_data_root
    jax_model_cache.clear()
    model_cache.clear()
    profiling.reset()


def _counts_from_codes(engine, batch, block=True, wire="auto"):
    """Stand-in for ``DeviceQueryEngine.count_hits``: for each record, a
    sum of its codes weighted by their place in the batch (even classes)
    and its count of invalid codes (odd classes)."""
    codes = batch.codes[: int(batch.offsets[-1])].astype(np.int64)
    per_base = ((codes + 1) * (np.arange(len(codes)) % 7 + 1), codes > 3)
    out = np.zeros((batch.num_records, engine.index.num_classes), dtype=np.int64)
    for c in range(out.shape[1]):
        total = np.concatenate(([0], np.cumsum(per_base[c % 2])))
        out[:, c] = total[batch.offsets[1:]] - total[batch.offsets[:-1]]
    return out


@pytest.fixture()
def counts_from_codes(clean, monkeypatch):
    monkeypatch.setattr(query.DeviceQueryEngine, "count_hits", _counts_from_codes)
    return clean


def _contigs(genomes, seed, n=4, lo=300, hi=1500):
    """``n`` pieces of the two genomes, every second one reverse-complemented."""
    rng = np.random.default_rng(seed)
    labels = sorted(genomes)
    out = []
    for i in range(n):
        g = genomes[labels[i % 2]]
        length = int(rng.integers(lo, hi))
        s = int(rng.integers(0, len(g) - length))
        seq = g[s : s + length]
        out.append(seq[::-1].translate(str.maketrans("ACGT", "TGCA")) if i % 2 else seq)
    return out


def _fasta(seqs, ids=None, width=60, eol="\n", header=lambda i, rid: f">{rid} contig {i}"):
    ids = ids or [f"c{i}" for i in range(len(seqs))]
    lines = []
    for i, (rid, seq) in enumerate(zip(ids, seqs)):
        lines.append(header(i, rid))
        lines += [seq[j : j + width] for j in range(0, len(seq), width)] if width else [seq]
    return (eol.join(lines) + eol).encode()


def _with(seqs, i, at, text):
    """``seqs`` with ``text`` put in at position ``at`` of sequence ``i``."""
    out = list(seqs)
    out[i] = out[i][:at] + text + out[i][at:]
    return out


def _long_line(genomes):
    """One unwrapped 70 kbp record: a line longer than the parse's 64 KiB buffer."""
    return [_contigs(genomes, 9, n=1)[0], "".join(_contigs(genomes, 10, n=60, lo=1100, hi=1200))]


# name: (file bytes from the genomes, route taken)
CASES = {
    "wrapped": (lambda g: _fasta(_contigs(g, 1)), PARSE),
    "unwrapped": (lambda g: _fasta(_contigs(g, 2), width=0), PARSE),
    "crlf": (lambda g: _fasta(_contigs(g, 3), eol="\r\n"), PARSE),
    "lower_case": (lambda g: _fasta([s.lower() for s in _contigs(g, 4)]), PARSE),
    "n_runs_and_iupac": (lambda g: _fasta(_with(_with(_contigs(g, 5), 0, 100, "N" * 80), 1, 50, "RYKMSWnnbd")), PARSE),
    "duplicate_ids": (lambda g: _fasta(_contigs(g, 6), ids=["a", "b", "a", "c"]), PARSE),
    "tabs_spaces_in_headers": (lambda g: _fasta(_contigs(g, 7), header=lambda i, rid: f">{rid}\tx  y \t"), PARSE),
    "blank_lines_no_final_newline": (lambda g: _fasta(_contigs(g, 8)).replace(b"\n>", b"\n\n\n>")[:-1], PARSE),
    "line_past_64_kib": (lambda g: _fasta(_long_line(g), width=0), PARSE),
    "empty_record": (lambda g: _fasta(_contigs(g, 11)).replace(b">c2", b">empty\n>c2"), PARSE),
    "record_of_k_bases": (lambda g: _fasta(_contigs(g, 12) + [g["470"][:K]]), PARSE),
    "header_only": (lambda g: b">only\n", PARSE),
    "empty_file": (lambda g: b"", READER),
    "blank_lines_only": (lambda g: b"\n\r\n\n", READER),
    "bases_before_the_first_header": (lambda g: b"ACGT\n" + _fasta(_contigs(g, 13)), READER),
    "byte_past_ascii": (lambda g: _fasta(_with(_contigs(g, 14), 1, 70, "é")), READER),
    "nul_byte": (lambda g: _fasta(_with(_contigs(g, 15), 2, 30, "\0")), READER),
    "bare_carriage_return": (lambda g: _fasta(_with(_contigs(g, 16), 0, 200, "\r")), READER),
    "vertical_tab_in_a_header": (lambda g: _fasta(_contigs(g, 17), header=lambda i, rid: f">{rid}\x0bx{i}"), READER),
    "file_separator_in_a_header": (lambda g: _fasta(_contigs(g, 18), header=lambda i, rid: f">{rid}\x1cx{i}"), READER),
    "space_before_the_id": (lambda g: _fasta(_contigs(g, 19), header=lambda i, rid: f"> {rid}"), READER),
    "gt_inside_a_line": (lambda g: _fasta(_with(_contigs(g, 20), 1, 100, ">x")), READER),
    "header_past_65000_bytes": (lambda g: _fasta(_contigs(g, 21), header=lambda i, rid: ">" + rid * (40000 if i == 1 else 1)), READER),
}


def _classify(path, out, **kwargs):
    """The facade's result bytes, or the error it raised."""
    try:
        classify.classify_species("Synthetic", path, out, device="cpu", **kwargs)
    except Exception as err:  # noqa: BLE001  the error is the result here
        return type(err), str(err)
    return out.read_bytes()


def _counters():
    return {n: e["calls"] for n, e in profiling.report().items() if n in (PARSE, READER)}


def _both_routes(path, tmp_path, monkeypatch, **kwargs):
    """``(result, counters)`` as the file routes itself, then the result
    with the line reader forced."""
    got = _classify(path, tmp_path / "got.json", **kwargs)
    calls = _counters()
    with monkeypatch.context() as m:
        m.setattr(native, "fasta_parse_matches_reader", lambda *a: False)
        want = _classify(path, tmp_path / "want.json", **kwargs)
    return got, calls, want


# the error each file raises on either route
ERRORS = {
    "empty_record": "Invalid sequence, must be longer than k",
    "record_of_k_bases": "Invalid sequence, must be longer than k",
    "header_only": "Invalid sequence, must be longer than k",
    "empty_file": "No sequences found in input",
    "blank_lines_only": "No sequences found in input",
    "bases_before_the_first_header": "Invalid FASTA file {path}: no header",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_fasta_file_gives_the_readers_result_on_either_route(counts_from_codes, tmp_path, monkeypatch, case):
    _, genomes = counts_from_codes
    make, route = CASES[case]
    path = tmp_path / "assembly.fasta"
    path.write_bytes(make(genomes))
    if route == PARSE:
        got, calls, want = _both_routes(path, tmp_path, monkeypatch)
        assert got == want
    else:  # one route, the reader's
        got, calls = _classify(path, tmp_path / "got.json"), _counters()
    assert calls == {route: 1}
    if case in ERRORS:
        assert got == (ValueError, ERRORS[case].format(path=path))
    else:
        assert isinstance(got, bytes) and b'"prediction"' in got


@pytest.mark.parametrize("max_bases,max_records", [
    (1, 65536), (2000, 65536), (2500, 65536), (1 << 23, 2), (2500, 3), (0, 0),
])
def test_batches_end_where_the_reader_ends_them(counts_from_codes, tmp_path, monkeypatch, max_bases, max_records):
    """Small batch limits: the parse cuts its batches at the reader's
    records (the engine sees the same names batch by batch) and the
    result is the same.  The records are 1,000 bases each, so 2,000
    bases end a batch exactly at a record."""
    _, genomes = counts_from_codes
    monkeypatch.setattr(filter_model, "_MAX_RECORD_BATCH_BASES", max_bases)
    monkeypatch.setattr(filter_model, "_MAX_RECORD_BATCH_RECORDS", max_records)
    path = tmp_path / "assembly.fa"
    path.write_bytes(_fasta(_contigs(genomes, 30, n=7, lo=1000, hi=1001), ids=["a", "b", "c", "a", "d", "e", "f"]))
    seen = []

    def spy(engine, batch, *args, **kwargs):
        seen.append(list(batch.record_names))
        return _counts_from_codes(engine, batch, *args, **kwargs)

    monkeypatch.setattr(query.DeviceQueryEngine, "count_hits", spy)
    got, calls, want = _both_routes(path, tmp_path, monkeypatch, step=3)
    assert got == want and calls == {PARSE: 1}
    half = len(seen) // 2
    assert seen[:half] == seen[half:] and len(seen) == 2 * half
    if max_bases <= 2500 or max_records <= 3:
        assert half > 1


@pytest.mark.parametrize("step", [1, 4])
def test_an_assembly_from_the_parse_writes_the_jax_json(clean, tmp_path, step):
    _, genomes = clean
    path = tmp_path / "assembly.fasta"
    path.write_bytes(_fasta(_contigs(genomes, 40 + step, n=9), ids=[f"NODE_{i}" for i in range(9)]))
    want, got = tmp_path / "jax.json", tmp_path / "torch.json"
    jax_classify.classify_species("Synthetic", path, want, step=step)
    classify.classify_species("Synthetic", path, got, step=step, device="cpu")
    assert profiling.report()[PARSE]["calls"] == 1
    assert got.read_bytes() == want.read_bytes()


def test_other_inputs_keep_the_reader(counts_from_codes, tmp_path):
    """A FASTQ file of mixed lengths takes the reader; a record list is no
    file and counts on neither counter."""
    root, genomes = counts_from_codes
    seqs = _contigs(genomes, 50)
    fastq = tmp_path / "reads.fastq"
    fastq.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(seqs)))
    fasta = tmp_path / "assembly.fasta"
    fasta.write_bytes(_fasta(seqs))
    model = filter_model.ProbabilisticFilterModel.load(root / "models" / "synthetic-species.json", device="cpu")
    for path, want in ((fastq, {READER: 1}), (fasta, {PARSE: 1})):
        profiling.reset()
        model.predict(path)
        assert _counters() == want
    profiling.reset()
    model.predict(list(get_record_iterator(fasta)))
    assert PARSE not in profiling.report() and READER not in profiling.report()


# ------------------------------------------------------------ batch_from_flat


def _records(rng, n, k):
    """``n`` records of k+1 to 3,000 bases, some with invalid codes."""
    out = []
    for i in range(n):
        length = k + 1 if i == 0 else int(rng.integers(k + 1, 3000))
        codes = rng.integers(0, 4, length).astype(np.uint8)
        if i % 3 == 0:
            codes[rng.integers(0, length, 3)] = 255
        out.append((f"r{i % 5}", codes))
    return out


@pytest.mark.parametrize("k,step,chunk,n", [
    (21, 1, 1024, 1), (21, 3, 1024, 13), (31, 1, 4096, 40), (5, 4, 512, 7), (21, 1, 1 << 16, 0),
])
def test_batch_from_flat_equals_the_jax_batch(k, step, chunk, n):
    """``prepare_batch`` and ``batch_from_flat(pad_codes(...))`` over the
    same records equal the JAX package's ``prepare_batch`` field by
    field; the record ids and validity are made on first read."""
    records = _records(np.random.default_rng(k * 100 + n), n, k)
    want = jax_query.prepare_batch(records, k, step=step, chunk=chunk)
    flat = np.concatenate([c for _, c in records]) if records else np.zeros(0, np.uint8)
    offsets = np.concatenate(([0], np.cumsum([len(c) for _, c in records]))).astype(np.int64)
    for got in (query.prepare_batch(records, k, step=step, chunk=chunk),
                query.batch_from_flat(query.pad_codes(flat, k, chunk), offsets, [r for r, _ in records], k, step)):
        assert got._rec_ids is None and got._valid is None
        for name in ("codes", "offsets", "rec_ids", "valid"):
            g, w = getattr(got, name), getattr(want, name)
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert (got.record_names, got.num_kmers, got.num_positions, got.step) == (
            want.record_names, want.num_kmers, want.num_positions, want.step)
        assert all(type(nk) is int for nk in got.num_kmers)


def test_only_the_raw_wire_makes_the_position_arrays(session_data_root):
    """The packed wire leaves the record ids and validity unmade; the raw
    wire makes them, with the same counts."""
    model = filter_model.ProbabilisticFilterModel.load(
        session_data_root[0] / "models" / "synthetic-species.json", device="cpu")
    engine = model.engine
    records = _records(np.random.default_rng(5), 5, model.k)
    batch = query.prepare_batch(records, model.k, step=2, chunk=1024)
    packed = engine.count_hits(batch, wire="packed")
    assert batch._rec_ids is None and batch._valid is None
    raw = engine.count_hits(batch, wire="raw")
    assert batch._rec_ids is not None and batch._valid is not None
    np.testing.assert_array_equal(packed, raw)
    rec_ids, valid = query.records_wire_plain(
        torch.from_numpy(query.packed_wire_for_batch(batch, 16)[2]), batch.num_positions, k=model.k, step=2)
    n_real = int(batch.offsets[-1])
    np.testing.assert_array_equal(valid.numpy(), batch.valid)
    np.testing.assert_array_equal(rec_ids[:n_real].numpy(), batch.rec_ids[:n_real])
    assert not batch.rec_ids[n_real:].any()
