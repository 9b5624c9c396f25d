"""The port's records route (assemblies, record lists) equals the JAX package's.

One index per geometry is built with the JAX package and carried across
with ``convert.index_from_arrays``; the same numpy-seeded records go
through ``xspect2_tpu.ops.query`` (JAX on the CPU), the port's engine on
the CPU (the kernels' plain versions) and the host reference
``count_hits_host``.  Models trained by the JAX package
(``session_registry``) classify the same files through both packages;
the result JSON must be byte-identical.  Every comparison is exact.
"""

import json

import numpy as np
import pytest
import torch

from tests.conftest import random_dna
from tests.test_torch_query import GEOMETRIES, _genomes, _jax_index
from xspect2_tpu import classify as jax_classify
from xspect2_tpu import model_cache as jax_model_cache
from xspect2_tpu.io.fasta import SeqRecord as JaxSeqRecord
from xspect2_tpu.io.fasta import write_fasta
from xspect2_tpu.models.svm_model import ProbabilisticFilterSVMModel as JaxSVMModel
from xspect2_tpu.ops import query as jax_query
from xspect2_tpu_torch import classify, convert, model_cache
from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.io.fasta import SeqRecord
from xspect2_tpu_torch.model_management import get_species_model_path
from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel
from xspect2_tpu_torch.ops import query

K = 21
CHUNK = 1024


@pytest.fixture(scope="module")
def indices():
    rng = np.random.default_rng(2024)
    out = {}
    for name, (num_classes, h) in GEOMETRIES.items():
        genomes = _genomes(rng, num_classes, 3000 if num_classes <= 40 else 400)
        jidx = _jax_index(genomes, K, h)
        out[name] = (jidx, convert.index_from_arrays(jidx.meta_dict(), jidx.table), genomes)
    return out


@pytest.fixture()
def fresh_caches():
    jax_model_cache.clear()
    model_cache.clear()
    yield
    jax_model_cache.clear()
    model_cache.clear()


def _records(rng, genomes, n, max_len):
    """Records from k+1 bases up to ``max_len``, half reverse-complemented,
    every third with an N; the first is exactly k+1 bases long."""
    out = []
    for i in range(n):
        g = genomes[i % len(genomes)]
        length = K + 1 if i == 0 else int(rng.integers(K + 1, min(max_len, len(g))))
        s = int(rng.integers(0, len(g) - length + 1))
        c = g[s : s + length].copy()
        if i % 2:
            c = 3 - c[::-1]
        if i % 3 == 0:
            c[int(rng.integers(0, length))] = 255
        out.append((f"r{i}", np.ascontiguousarray(c)))
    return out


def _host_counts(idx, records, step):
    return np.stack(
        [idx.count_hits_host(*dna.canonical_kmers(c, K, step=step)) for _, c in records]
    )


# ------------------------------------------------------------ batch layer


@pytest.mark.parametrize("step", [1, 3])
@pytest.mark.parametrize("n_records", [1, 12])
def test_prepared_batches_and_wire_equal_the_jax_package(step, n_records):
    rng = np.random.default_rng(step * 100 + n_records)
    genomes = _genomes(rng, 3, 2500)
    records = _records(rng, genomes, n_records, 2400)
    got = query.prepare_batch(records, K, step=step, chunk=CHUNK)
    want = jax_query.prepare_batch(records, K, step=step, chunk=CHUNK)
    for name in ("codes", "rec_ids", "valid", "offsets"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.record_names, got.num_kmers, got.step) == (
        want.record_names, want.num_kmers, want.step,
    )
    assert got.num_kmers == [-(-(len(c) - K + 1) // step) for _, c in records]
    max_records = query._next_pow2(max(8, n_records))
    for g, w in zip(
        query.packed_wire_for_batch(got, max_records),
        (np.asarray(a) for a in jax_query.packed_wire_for_batch(want, max_records)),
    ):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)

    mat = np.stack([genomes[0][i : i + 150] for i in range(0, 1500, 100)])
    got = query.prepare_fixed_batch(mat, K, step=step, chunk=CHUNK)
    want = jax_query.prepare_fixed_batch(mat, K, step=step, chunk=CHUNK)
    for name in ("codes", "rec_ids", "valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.offsets is None and want.offsets is None
    assert (got.record_names, got.num_kmers) == (want.record_names, want.num_kmers)


def test_prepare_batch_rejects_records_not_longer_than_k():
    for prep in (query.prepare_batch, jax_query.prepare_batch):
        with pytest.raises(ValueError, match="longer than k"):
            prep([("x", np.zeros(K, dtype=np.uint8))], k=K)
    for prep in (query.prepare_fixed_batch, jax_query.prepare_fixed_batch):
        with pytest.raises(ValueError, match="longer than k"):
            prep(np.zeros((3, K), dtype=np.uint8), k=K)


# ------------------------------------------------------------ engine


@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("step", [1, 3])
@pytest.mark.parametrize("n_records", [1, 11])
def test_count_hits_matches_jax_and_host(indices, name, step, n_records):
    jidx, idx, genomes = indices[name]
    rng = np.random.default_rng(len(name) * 7 + step + n_records)
    records = _records(rng, genomes, n_records, len(genomes[0]))
    want = jax_query.DeviceQueryEngine(jidx, chunk=CHUNK).count_hits(
        jax_query.prepare_batch(records, K, step=step, chunk=CHUNK)
    )
    np.testing.assert_array_equal(want, _host_counts(idx, records, step))
    engine = query.DeviceQueryEngine(idx, device="cpu", chunk=CHUNK)
    batch = query.prepare_batch(records, K, step=step, chunk=engine.chunk)
    for wire in ("packed", "raw", "auto"):
        np.testing.assert_array_equal(engine.count_hits(batch, wire=wire), want, err_msg=wire)
    np.testing.assert_array_equal(engine.count_hits_records(records, step=step), want)


def test_unsynchronized_count_hits_is_the_padded_tensor(indices):
    _, idx, genomes = indices["c40_cw2_h7"]
    records = _records(np.random.default_rng(3), genomes, 9, 600)
    engine = query.DeviceQueryEngine(idx, device="cpu", chunk=CHUNK)
    batch = query.prepare_batch(records, K, chunk=engine.chunk)
    out = engine.count_hits(batch, block=False)
    assert out.dtype == torch.int32 and tuple(out.shape) == (16, 40)
    assert int(out[9:].sum()) == 0
    np.testing.assert_array_equal(out[:9].long().numpy(), _host_counts(idx, records, 1))


@pytest.mark.parametrize("step", [1, 3])
def test_raw_wire_fixed_batch_with_padding(indices, step):
    """prepare_fixed_batch pads with record id 0 (never valid): rec_ids
    are not monotone, and the padding counts nothing."""
    jidx, idx, genomes = indices["c8_p4_h2"]
    rng = np.random.default_rng(step)
    mat = np.stack([genomes[int(rng.integers(0, 8))][s : s + 150] for s in range(0, 2600, 200)])
    mat[2, 10] = 255
    batch = query.prepare_fixed_batch(mat, K, step=step, chunk=CHUNK)
    assert batch.num_positions > mat.size and batch.offsets is None
    engine = query.DeviceQueryEngine(idx, device="cpu", chunk=CHUNK)
    got = engine.count_hits(batch)
    want = jax_query.DeviceQueryEngine(jidx, chunk=CHUNK).count_hits(
        jax_query.prepare_fixed_batch(mat, K, step=step, chunk=CHUNK)
    )
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _host_counts(idx, list(enumerate(mat)), step))


def test_count_hits_wire_validation(indices):
    _, idx, genomes = indices["c8_p4_h2"]
    engine = query.DeviceQueryEngine(idx, device="cpu", chunk=CHUNK)
    batch = query.prepare_fixed_batch(np.stack([genomes[0][:150]] * 3), K, chunk=CHUNK)
    with pytest.raises(ValueError, match="unknown wire format 'pack'"):
        engine.count_hits(batch, wire="pack")
    with pytest.raises(ValueError, match="requires a batch with record offsets"):
        engine.count_hits(batch, wire="packed")
    empty = query.prepare_batch([], K, chunk=CHUNK)
    assert engine.count_hits(empty).shape == (0, 8)


def test_chunk_rule_matches_the_jax_engine(indices):
    """The JAX default (65,536) is read from the environment, which the
    test configuration sets; compare at explicit chunks."""
    for name in GEOMETRIES:
        jidx, idx, _ = indices[name]
        for chunk in (1 << 16, 4096):
            assert query.DeviceQueryEngine(idx, device="cpu", chunk=chunk).chunk == (
                jax_query.DeviceQueryEngine(jidx, chunk=chunk).chunk
            ), name
    assert query.DeviceQueryEngine(indices["c512_cw16_h3"][1], device="cpu").chunk == 32768


def test_records_wire_plain_matches_the_prepared_batch():
    """K4's plain version derives the raw wire's record ids and validity
    (record ids differ only on padding, where JAX clamps to the last slot)."""
    rng = np.random.default_rng(8)
    genomes = _genomes(rng, 2, 3000)
    for step in (1, 3):
        for n in (1, 8, 13):
            batch = query.prepare_batch(_records(rng, genomes, n, 900), K, step=step, chunk=CHUNK)
            max_records = query._next_pow2(max(8, n))
            offsets = torch.from_numpy(query.packed_wire_for_batch(batch, max_records)[2])
            rec, valid = query.records_wire(offsets, batch.num_positions, k=K, step=step)
            n_real = int(batch.offsets[-1])
            np.testing.assert_array_equal(valid.numpy(), batch.valid)
            np.testing.assert_array_equal(rec[:n_real].numpy(), batch.rec_ids[:n_real])
            assert (rec[n_real:] == max_records - 1).all()


def test_records_query_drops_record_ids_out_of_range(indices):
    _, idx, genomes = indices["c8_p4_h2"]
    engine = query.DeviceQueryEngine(idx, device="cpu", chunk=CHUNK)
    batch = query.prepare_batch(_records(np.random.default_rng(4), genomes, 3, 900), K, chunk=CHUNK)
    codes, rec_ids, valid = (torch.from_numpy(a) for a in (batch.codes, batch.rec_ids, batch.valid))
    geom = dict(max_records=8, **engine.geometry())
    full = query.records_query(codes, rec_ids, valid, engine.table, **geom)
    moved = rec_ids.clone()
    moved[rec_ids == 1] = 8
    moved[rec_ids == 2] = -1
    out = query.records_query(codes, moved, valid, engine.table, **geom)
    assert torch.equal(out[0], full[0]) and int(out[1:].sum()) == 0
    with pytest.raises(ValueError, match="n_pos \\+ k - 1"):
        query.records_query(codes[:-1], rec_ids, valid, engine.table, **geom)


# ------------------------------------------------------------ models


def _svm_model(device="cpu"):
    return ProbabilisticFilterSVMModel.load(get_species_model_path("Synthetic"), device=device)


def _write_equal_length(path, genomes, n, length):
    labels = sorted(genomes)
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            g = genomes[labels[i % 2]]
            s = (37 * i) % (len(g) - length)
            f.write(f">seq{i}\n{g[s : s + length]}\n")


def _assembly(rng, genome, n_contigs, path, name):
    """A draft assembly: contigs of uneven lengths, half reverse-complemented,
    one with a run of Ns."""
    cuts = np.sort(rng.choice(np.arange(200, len(genome) - 200), n_contigs - 1, replace=False))
    bounds = [0, *cuts.tolist(), len(genome)]
    records = []
    for i in range(n_contigs):
        seq = genome[bounds[i] : bounds[i + 1]]
        if i % 2:
            seq = seq[::-1].translate(str.maketrans("ACGT", "TGCA"))
        if i == 1:
            seq = seq[:50] + "N" * 20 + seq[70:]
        records.append(JaxSeqRecord(seq, id=f"{name}_contig{i}"))
    write_fasta(records, path)


@pytest.mark.parametrize("kind", ["one_record", "forty_equal"])
def test_small_files_take_the_records_route(
    session_data_root, tmp_path, fresh_caches, monkeypatch, kind
):
    """A one-record FASTA and a 40-record file of one length are not read
    matrices: the port must not pad them into the reads route."""
    _, genomes = session_data_root
    path = tmp_path / "in.fasta"
    if kind == "one_record":
        write_fasta([JaxSeqRecord(genomes["470"][1000:4000], id="genome")], path)
    else:
        _write_equal_length(path, genomes, 40, 150)

    def no_reads_route(*args, **kwargs):
        raise AssertionError("the reads route was taken")

    monkeypatch.setattr(query.DeviceQueryEngine, "count_hits_reads", no_reads_route)
    want, got = tmp_path / "jax.json", tmp_path / "torch.json"
    jax_classify.classify_species("Synthetic", path, want)
    classify.classify_species("Synthetic", path, got, device="cpu")
    assert got.read_bytes() == want.read_bytes()


def test_a_file_of_600_equal_reads_keeps_the_reads_route(
    session_data_root, tmp_path, fresh_caches, monkeypatch
):
    _, genomes = session_data_root
    path = tmp_path / "reads.fasta"
    _write_equal_length(path, genomes, 600, 150)

    def no_records_route(*args, **kwargs):
        raise AssertionError("the records route was taken")

    monkeypatch.setattr(query.DeviceQueryEngine, "count_hits", no_records_route)
    want, got = tmp_path / "jax.json", tmp_path / "torch.json"
    jax_classify.classify_genus("Synthetic", path, want)
    classify.classify_genus("Synthetic", path, got, device="cpu")
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("step,display_name,exclude_ids", [
    (1, False, None), (3, True, None), (1, False, ["471"]),
])
def test_assembly_directory_result_json_is_byte_identical(
    session_data_root, tmp_path, fresh_caches, step, display_name, exclude_ids
):
    _, genomes = session_data_root
    rng = np.random.default_rng(step)
    in_dir = tmp_path / "assemblies"
    in_dir.mkdir()
    for j, label in enumerate(("470", "471", "470")):
        _assembly(rng, genomes[label], 3 + 2 * j, in_dir / f"asm{j}.fna", f"a{j}")
    kwargs = dict(step=step, display_name=display_name, exclude_ids=exclude_ids)
    jax_classify.classify_species("Synthetic", in_dir, tmp_path / "jax" / "r.json", **kwargs)
    classify.classify_species(
        "Synthetic", in_dir, tmp_path / "torch" / "r.json", device="cpu", **kwargs
    )
    for j in (1, 2, 3):
        name = f"r_{j}.json"
        got = (tmp_path / "torch" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
        assert json.loads(got)["prediction"] in ("470", "471")
    jax_classify.classify_genus("Synthetic", in_dir, tmp_path / "jax" / "g.json", step=step)
    classify.classify_genus("Synthetic", in_dir, tmp_path / "torch" / "g.json", step=step, device="cpu")
    for j in (1, 2, 3):
        name = f"g_{j}.json"
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def _record_inputs(genomes, rng):
    seqs = [genomes["470"][100:900], random_dna(rng, 300), genomes["471"][2000:2030]]
    return (
        [JaxSeqRecord(s, id=f"s{i}") for i, s in enumerate(seqs)],
        [SeqRecord(s, id=f"s{i}") for i, s in enumerate(seqs)],
    )


@pytest.mark.parametrize("form", ["record", "list", "iterator"])
def test_record_inputs_give_the_jax_result(session_data_root, tmp_path, form):
    root, genomes = session_data_root
    jax_recs, recs = _record_inputs(genomes, np.random.default_rng(5))
    if form == "record":
        jax_in, port_in = jax_recs[0], recs[0]
    elif form == "list":
        jax_in, port_in = jax_recs, recs
    else:
        jax_in, port_in = iter(jax_recs), iter(recs)
    jax_model = JaxSVMModel.load(root / "models" / "synthetic-species.json")
    want, got = tmp_path / "jax.json", tmp_path / "torch.json"
    jax_model.predict(jax_in, step=2).save(want)
    _svm_model().predict(port_in, step=2).save(got)
    assert got.read_bytes() == want.read_bytes()


def test_calculate_hits_and_count_kmers_match(session_data_root):
    root, genomes = session_data_root
    jax_model = JaxSVMModel.load(root / "models" / "synthetic-species.json")
    model = _svm_model()
    jax_recs, recs = _record_inputs(genomes, np.random.default_rng(6))
    for step in (1, 4):
        for jr, r in zip(jax_recs, recs):
            assert model.calculate_hits(r, step=step) == jax_model.calculate_hits(jr, step=step)
            assert model.calculate_hits(r.seq, exclude_ids=["470"], step=step) == (
                jax_model.calculate_hits(jr.seq, exclude_ids=["470"], step=step)
            )
        assert model._count_kmers(recs, step=step) == jax_model._count_kmers(jax_recs, step=step)
    assert model.calculate_hits(genomes["470"][:500])["470"] == 480
    with pytest.raises(ValueError, match="longer than k"):
        model.calculate_hits("ACGT" * 5)
    with pytest.raises(ValueError, match="string or SeqRecord"):
        model.calculate_hits(42)
    with pytest.raises(ValueError, match="Invalid sequence input"):
        model.predict(["not a record"])
    with pytest.raises(ValueError, match="No sequences found"):
        model.predict([])


@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("n_blk,step", [(2, 1), (3, 3), (4, 1)])
def test_owned_block_records_query_matches_the_jax_block_sharded_body(indices, name, n_blk, step):
    """``records_query`` with ``local_blocks``/``block_offset`` on each
    block shard equals the JAX package's query body in its block-sharded
    mode (run on the CPU, on the same shard in its class-word-major
    layout), and the shards sum to the unsharded counts."""
    import jax.numpy as jnp

    from xspect2_tpu_torch.parallel.block_sharded import blk_table_shard

    jidx, idx, genomes = indices[name]
    records = _records(np.random.default_rng(n_blk + step), genomes, 9, len(genomes[0]))
    batch = query.prepare_batch(records, K, step=step, chunk=CHUNK)
    max_records = 16
    local_blocks = -(-idx.num_blocks // n_blk)
    engine = query.DeviceQueryEngine(idx, device="cpu", chunk=CHUNK)
    body = jax_query.make_query_body(
        k=K, num_hashes=idx.num_hashes, rows_per_block=idx.rows_per_block,
        class_words=idx.class_words, num_classes=idx.num_classes, chunk=CHUNK,
        num_chunks=batch.num_positions // CHUNK, max_records=max_records,
        fields_per_word=idx.fields_per_word, local_blocks=local_blocks,
    )
    inputs = [torch.from_numpy(a) for a in (batch.codes, batch.rec_ids, batch.valid)]
    total = np.zeros((max_records, idx.num_classes), dtype=np.int64)
    for m in range(n_blk):
        shard = blk_table_shard(idx, n_blk, m)
        jshard = shard.reshape(local_blocks, idx.rows_per_block, idx.class_words).transpose(0, 2, 1)
        want = np.asarray(body(
            jnp.asarray(jshard.reshape(local_blocks, -1)), jnp.asarray(batch.codes), jnp.asarray(batch.rec_ids),
            jnp.asarray(batch.valid), int(idx.num_blocks), jnp.int32(m * local_blocks),
        ))
        got = query.records_query(
            *inputs, torch.from_numpy(shard.view(np.int32)), max_records=max_records,
            **engine.geometry(), local_blocks=local_blocks, block_offset=m * local_blocks,
        ).numpy()
        np.testing.assert_array_equal(got, want)
        total += got
    np.testing.assert_array_equal(total[: len(records)], _host_counts(idx, records, step))
    assert total.sum() > 0
