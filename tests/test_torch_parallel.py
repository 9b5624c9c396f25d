"""The port's sharded classifiers equal the JAX package's, shard by shard.

One index per geometry is built with the JAX package and carried across
with ``convert.index_from_arrays``; the same numpy-seeded reads and
records go through ``xspect2_tpu.parallel`` on the 8-virtual-device CPU
mesh of ``tests/conftest.py`` and through ``xspect2_tpu_torch.parallel``
with ``device="cpu"`` (the kernels' plain versions).  Hit counts must be
equal (tolerance 0), total scores equal as float32 bit patterns, and the
predicted class the same.

In-process the port evaluates every shard of a mesh in turn
(``_local_reads_step`` and ``_local_step`` for every coordinate) and the
test combines them by hand: a concatenation over ``cls``, a sum over
``blk``, a concatenation (hits) or sum (totals) over ``data``.  That
hand-combine is the plain version of the collectives.  Three tests run
the collectives themselves across real processes joined by gloo.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from xspect2_tpu.core import dna as jax_dna
from xspect2_tpu.core.blocked_index import BlockedBitSlicedIndex as JaxIndex
from xspect2_tpu.models.svm_head import JaxSVMHead, fit_svc
from xspect2_tpu.parallel import BlockShardedClassifier as JaxBlockSharded
from xspect2_tpu.parallel import ShardedClassifier as JaxSharded
from xspect2_tpu.parallel import make_block_mesh as jax_make_block_mesh
from xspect2_tpu.parallel import make_mesh as jax_make_mesh
from xspect2_tpu.parallel.sharded import _round2 as jax_round2
from xspect2_tpu_torch import convert
from xspect2_tpu_torch.ops import query
from xspect2_tpu_torch.parallel import (
    BlockShardedClassifier,
    ShardedClassifier,
    distributed,
    make_block_mesh,
    make_mesh,
)
from xspect2_tpu_torch.parallel.mesh import BLK_AXIS, CLS_AXIS, DATA_AXIS, Mesh
from xspect2_tpu_torch.parallel.sharded import _round2

ROOT = Path(__file__).resolve().parent.parent
K = 21
CHUNK = 512
RPC = 8  # reads per chunk: 21 reads need padding on every mesh
# classes -> (num_hashes, genome length): C=1 (P=32) and C=8 (P=4) are the
# field-packed tables, 40 and 64 have 2 class words, 512 has 16
GEOMETRIES = {1: (3, 1500), 8: (2, 1500), 40: (7, 1200), 64: (4, 900), 512: (3, 300)}


@pytest.fixture(scope="module")
def indices():
    """classes -> (JAX index, the port's index, genomes)."""
    rng = np.random.default_rng(404)
    out = {}
    for num_classes, (h, length) in GEOMETRIES.items():
        genomes = [rng.integers(0, 4, size=length, dtype=np.uint8) for _ in range(num_classes)]
        jidx = JaxIndex.create(K, [f"c{i:03d}" for i in range(num_classes)], length, fpr=0.01, num_hashes=h)
        for ci, g in enumerate(genomes):
            jidx.insert_kmers(ci, *jax_dna.canonical_kmers(g, K))
        out[num_classes] = (jidx, convert.index_from_arrays(jidx.meta_dict(), jidx.table), genomes)
    return out


def _reads(genomes, seed, n=21, length=150):
    """Reads from random classes, half reverse-complemented, three with an N."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, length), dtype=np.uint8)
    for i in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        s = int(rng.integers(0, len(g) - length))
        out[i] = 3 - g[s : s + length][::-1] if i % 2 else g[s : s + length]
    out[1, 5] = out[2, 0] = out[n - 1, length // 2] = 255
    return out


def _records(genomes, seed, n=11):
    """Ragged records (k+1 bases and up), every third with an N."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = genomes[i % len(genomes)]
        length = K + 1 if i == 0 else int(rng.integers(K + 1, len(g)))
        s = int(rng.integers(0, len(g) - length + 1))
        c = g[s : s + length].copy()
        if i % 2:
            c = 3 - c[::-1]
        if i % 3 == 0:
            c[int(rng.integers(0, length))] = 255
        out.append((f"r{i}", np.ascontiguousarray(c)))
    return out


def _heads(idx, seed=3, n_labels=5):
    """The same fitted SVM head for both packages: a few labels over the
    index's whole score space.  The JAX head keeps float32 arrays; the
    port's head holds the same values in float64."""
    rng = np.random.default_rng(seed)
    n_labels = min(n_labels, idx.num_classes)
    x = rng.normal(0.2, 0.2, size=(8 * n_labels, idx.num_classes))
    y = [idx.class_names[i % n_labels] for i in range(len(x))]
    jhead = JaxSVMHead.from_sklearn(fit_svc(x, y, "rbf", 1.0))
    head = convert.svm_head_from_arrays(
        jhead.support_vectors, jhead.dual_coef, jhead.intercept, jhead.n_support,
        jhead.classes, jhead.kernel, jhead.gamma, jhead.degree, jhead.coef0,
    )
    return jhead, head


def hand_mesh(axis, n_data, n_model) -> Mesh:
    """A mesh of ``n_data x n_model`` coordinates without process groups:
    its collectives raise, so only the per-coordinate steps can run."""
    return Mesh({DATA_AXIS: n_data, axis: n_model}, (0, 0), {DATA_AXIS: None, axis: None},
                torch.device("cpu"))


def _merge_model(clf, parts):
    """The model-axis collective by hand: concatenate the class axis over
    ``cls``, sum over ``blk``."""
    if clf.model_axis == CLS_AXIS:
        return torch.cat(parts, dim=-1)
    return torch.stack(parts).sum(dim=0, dtype=torch.int32)


def hand_count_hits_reads(clf, reads, step):
    rows = []
    for d in range(clf.n_data):
        parts = []
        for m in range(clf.n_model):
            hits, row_start = clf._local_reads_step((d, m), reads, step, RPC)
            assert row_start == d * hits.shape[0]
            parts.append(hits)
        rows.append(_merge_model(clf, parts))
    full = torch.cat(rows)
    assert full.shape[0] % (clf.n_data * RPC) == 0 and full.shape[0] - len(reads) < clf.n_data * RPC
    assert int(full[len(reads):].sum()) == 0  # padding rows count nothing
    return full[: len(reads), : clf.index.num_classes].numpy().astype(np.int64)


def hand_classify(clf, records, step):
    batches, max_records = clf._shard_batches(records, step)
    full = [
        _merge_model(clf, [clf._local_step((d, m), batches[d], max_records) for m in range(clf.n_model)])
        for d in range(clf.n_data)
    ]
    total_hits = torch.stack([f.sum(dim=0, dtype=torch.int32) for f in full]).sum(dim=0, dtype=torch.int32)
    total_kmers = torch.tensor(sum(sum(b.num_kmers) for b in batches), dtype=torch.int32)
    scores, pred = clf.score(total_hits, total_kmers)
    assert scores.dtype == torch.float32
    return clf.assemble(
        torch.stack(full).numpy(), scores.numpy(), int(pred), [b.record_names for b in batches]
    )


def _assert_same_classification(got, want):
    per_record, totals, prediction = got
    j_per_record, j_totals, j_prediction = want
    assert per_record == j_per_record
    assert list(totals) == list(j_totals)
    a = np.array(list(totals.values()), dtype=np.float32)
    b = np.array(list(j_totals.values()), dtype=np.float32)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert prediction == j_prediction


# ------------------------------------------------------------------ cls


@pytest.mark.parametrize("num_classes", [64, 512])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (1, 2), (2, 2), (2, 4)])
def test_cls_sharded_equals_the_jax_classifier(indices, mesh_shape, num_classes):
    jidx, idx, genomes = indices[num_classes]
    jhead, head = _heads(idx) if num_classes == 64 else (None, None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # 64 classes on 4 cls shards pad
        jclf = JaxSharded(jidx, jax_make_mesh(*mesh_shape), svm_head=jhead, chunk=CHUNK)
        clf = ShardedClassifier(idx, hand_mesh(CLS_AXIS, *mesh_shape), svm_head=head, chunk=CHUNK)
    step = 1 + (mesh_shape[0] + mesh_shape[1]) % 2
    reads = _reads(genomes, seed=num_classes + step)
    want = jclf.count_hits_reads(reads, step=step, reads_per_chunk=RPC)
    got = hand_count_hits_reads(clf, reads, step)
    np.testing.assert_array_equal(got, want)
    engine = query.DeviceQueryEngine(idx, device="cpu")
    np.testing.assert_array_equal(got, engine.count_hits_reads(reads, step=step, reads_per_chunk=RPC))
    assert int(got.sum()) > 0

    records = _records(genomes, seed=7)
    _assert_same_classification(hand_classify(clf, records, step), jclf.classify(records, step=step))


@pytest.mark.parametrize("num_classes", [1, 8])
def test_cls_refuses_field_packed_indices_as_the_jax_classifier_does(indices, num_classes):
    jidx, idx, _ = indices[num_classes]
    assert idx.fields_per_word > 1
    with pytest.raises(ValueError, match="no class-word axis") as jax_err:
        JaxSharded(jidx, jax_make_mesh(2, 2))
    with pytest.raises(ValueError, match="no class-word axis") as err:
        ShardedClassifier(idx, hand_mesh(CLS_AXIS, 2, 2))
    assert str(err.value) == str(jax_err.value)
    ShardedClassifier(idx, hand_mesh(CLS_AXIS, 2, 1))  # n_cls=1 is fine


# ------------------------------------------------------------------ blk


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("num_classes", [1, 8, 40, 64])
@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (1, 4), (2, 4)])
def test_blk_sharded_equals_the_jax_classifier(indices, mesh_shape, num_classes, step):
    jidx, idx, genomes = indices[num_classes]
    jhead, head = _heads(idx) if num_classes > 1 else (None, None)
    jclf = JaxBlockSharded(jidx, jax_make_block_mesh(*mesh_shape), svm_head=jhead, chunk=CHUNK)
    clf = BlockShardedClassifier(idx, hand_mesh(BLK_AXIS, *mesh_shape), svm_head=head, chunk=CHUNK)
    assert clf.local_blocks == jclf.local_blocks
    reads = _reads(genomes, seed=num_classes + step)
    want = jclf.count_hits_reads(reads, step=step, reads_per_chunk=RPC)
    got = hand_count_hits_reads(clf, reads, step)
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) > 0
    if step == 1:
        records = _records(genomes, seed=mesh_shape[1])
        _assert_same_classification(hand_classify(clf, records, 1), jclf.classify(records, step=1))


def test_blk_shards_of_a_block_count_that_does_not_divide_sum_to_the_engine(indices):
    """An odd number of block shards pads the stack; every shard's partial
    count is at most the whole count and they sum to it."""
    _, idx, genomes = indices[40]
    n_blk = next(n for n in (3, 5, 7) if idx.num_blocks % n)
    clf = BlockShardedClassifier(idx, hand_mesh(BLK_AXIS, 1, n_blk), chunk=CHUNK)
    assert clf.blocks_pad == clf.local_blocks * n_blk > idx.num_blocks
    reads = _reads(genomes, seed=1)
    whole = query.DeviceQueryEngine(idx, device="cpu").count_hits_reads(reads, reads_per_chunk=RPC)
    parts = [
        clf._local_reads_step((0, m), reads, 1, RPC)[0][: len(reads)].numpy() for m in range(n_blk)
    ]
    assert all((p <= whole).all() and 0 < p.sum() < whole.sum() for p in parts)
    np.testing.assert_array_equal(sum(parts), whole)


def test_host_sharded_input_equals_the_global_input(indices):
    """count_hits_reads_local, every data shard passing only its reads,
    equals count_hits_reads on all of them (the JAX classifier's too)."""
    jidx, idx, genomes = indices[40]
    reads = _reads(genomes, seed=5, n=28)
    jclf = JaxBlockSharded(jidx, jax_make_block_mesh(4, 2), chunk=CHUNK)
    want = jclf.count_hits_reads_local(reads, reads_per_chunk=RPC)
    clf = BlockShardedClassifier(idx, hand_mesh(BLK_AXIS, 4, 2), chunk=CHUNK)
    rows = []
    for d in range(4):
        mine = reads[d * 7 : (d + 1) * 7]
        parts = [clf._query_reads(m, mine, RPC, 1) for m in range(2)]
        rows.append(_merge_model(clf, parts)[:7, : idx.num_classes])
    np.testing.assert_array_equal(torch.cat(rows).numpy(), want)
    np.testing.assert_array_equal(want, hand_count_hits_reads(clf, reads, 1))


# ------------------------------------------------------------------ units


def test_round2_rounds_half_to_even_like_the_jax_step():
    """Bit for bit the compiled JAX function (inside the jitted step XLA
    turns the division by 100 into a product with float32 0.01, which
    differs from the eager quotient by at most one ulp)."""
    x = np.concatenate([
        np.array([0.0, 0.005, 0.015, 0.025, 0.125, 0.135, 0.995, 1.0, 0.37, 2 / 3], dtype=np.float32),
        np.random.default_rng(0).random(5000, dtype=np.float32),
    ])
    got = _round2(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax_round2)(x))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    eager = np.asarray(jax_round2(x))
    assert np.abs(got.view(np.int32) - eager.view(np.int32)).max() <= 1
    assert got.dtype == np.float32
    # 12.5 and 13.5 hundredths round to the even neighbour
    np.testing.assert_allclose(_round2(torch.tensor([0.125, 0.135])).numpy(), [0.12, 0.14], atol=1e-7)


def test_mesh_errors_and_defaults_in_a_world_of_one():
    """An uninitialised process is a world of one rank: the JAX package's
    two errors, with its device count replaced by the world's."""
    assert not torch.distributed.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.coords, mesh.size) == ({DATA_AXIS: 1, CLS_AXIS: 1}, (0, 0), 1)
    assert make_block_mesh(1, 1, device="cpu").shape == {DATA_AXIS: 1, BLK_AXIS: 1}
    for make, axis in ((make_mesh, "cls"), (make_block_mesh, "blk")):
        with pytest.raises(ValueError, match=f"1 devices not divisible by n_{axis}=2"):
            make(None, 2, device="cpu")
        with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 1"):
            make(2, 2, device="cpu")
    with pytest.raises(ValueError, match="8 devices not divisible by n_cls=3"):
        jax_make_mesh(None, 3)
    with pytest.raises(ValueError, match="mesh 3x3 needs 9 devices, have 8"):
        jax_make_mesh(3, 3)
    assert distributed.initialize(device="cpu") == {
        "process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1,
    }
    assert distributed.local_data_shard(list(range(7)), axis_size=3) == [0, 3, 6]
    assert distributed.local_data_shard(list(range(7))) == list(range(7))


def test_a_mesh_without_process_groups_refuses_collectives(indices):
    """No entry point falls back to the hand-combine: a public method on a
    mesh of several coordinates needs the process groups."""
    _, idx, genomes = indices[40]
    clf = BlockShardedClassifier(idx, hand_mesh(BLK_AXIS, 1, 2), chunk=CHUNK)
    with pytest.raises(RuntimeError, match="no process group"):
        clf.count_hits_reads(_reads(genomes, 1), reads_per_chunk=RPC)
    with pytest.raises(RuntimeError, match="no process group"):
        clf.classify(_records(genomes, 1))
    unreplicated = ShardedClassifier(idx, hand_mesh(CLS_AXIS, 2, 1), chunk=CHUNK, replicate_out=False)
    with pytest.raises(RuntimeError, match="replicate_out=True"):
        unreplicated.classify(_records(genomes, 1))


def test_block_classifier_refuses_a_mesh_without_blk_axis(indices):
    jidx, idx, _ = indices[40]
    with pytest.raises(ValueError, match="blk") as jax_err:
        JaxBlockSharded(jidx, jax_make_mesh(4, 2))
    with pytest.raises(ValueError, match="blk") as err:
        BlockShardedClassifier(idx, make_mesh(device="cpu"))
    assert str(err.value) == str(jax_err.value) == "mesh has no 'blk' axis: use make_block_mesh"


def test_more_cls_shards_than_class_words_warn_and_pad(indices):
    jidx, idx, _ = indices[40]
    with pytest.warns(UserWarning, match="exceeds index class_words") as jax_warned:
        JaxSharded(jidx, jax_make_mesh(2, 4))
    with pytest.warns(UserWarning, match="exceeds index class_words") as warned:
        clf = ShardedClassifier(idx, hand_mesh(CLS_AXIS, 2, 4))
    assert str(warned[0].message) == str(jax_warned[0].message)
    assert (clf.cw_pad, clf.cw_local) == (4, 1)
    assert not clf.host_table_shard(2).any() and not clf.host_table_shard(3).any()
    assert clf.shard_geometry(3)["num_classes"] == 32


@pytest.mark.parametrize("n_data", [1, 3, 4])
def test_prepare_shard_batches_equal_the_jax_arrays(indices, n_data):
    jidx, idx, genomes = indices[40]
    records = _records(genomes, seed=n_data, n=3 if n_data == 4 else 9)  # 4 shards, 3 records: one is empty
    jclf = JaxSharded(jidx, jax_make_mesh(n_data, 2), chunk=CHUNK)
    clf = ShardedClassifier(idx, hand_mesh(CLS_AXIS, n_data, 2), chunk=CHUNK)
    for step in (1, 3):
        got = clf.prepare_shard_batches(records, step)
        want = jclf.prepare_shard_batches(records, step)
        for g, w in zip(got[:4], want[:4]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert got[4] == want[4]


@pytest.mark.parametrize("axis,num_classes,n_shards", [
    ("cls", 64, 2), ("cls", 40, 4), ("cls", 512, 4), ("blk", 8, 2), ("blk", 1, 4), ("blk", 40, 8),
])
def test_table_shards_equal_the_jax_classifiers_addressable_shards(indices, axis, num_classes, n_shards):
    jidx, idx, _ = indices[num_classes]
    shards = convert.table_shards(jidx.meta_dict(), jidx.table, axis, n_shards)
    assert len(shards) == n_shards and all(s.dtype == torch.int32 for s in shards)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        if axis == "cls":
            jclf = JaxSharded(jidx, jax_make_mesh(8 // n_shards, n_shards))
            clf = ShardedClassifier(idx, hand_mesh(CLS_AXIS, 1, n_shards))
            dim, per_shard = 1, jclf.cw_local
        else:
            jclf = JaxBlockSharded(jidx, jax_make_block_mesh(8 // n_shards, n_shards))
            clf = BlockShardedClassifier(idx, hand_mesh(BLK_AXIS, 1, n_shards))
            dim, per_shard = 0, jclf.local_blocks
    seen = set()
    for s in jclf.table3.addressable_shards:
        coord = (s.index[dim].start or 0) // per_shard
        # [blocks, class words, rows] there, row-major [blocks, rows, class words] here
        data = np.asarray(s.data).transpose(0, 2, 1)
        np.testing.assert_array_equal(
            shards[coord].numpy().view(np.uint32), data.reshape(data.shape[0], -1))
        seen.add(coord)
    assert seen == set(range(n_shards))
    np.testing.assert_array_equal(clf.table.numpy(), shards[0].numpy())  # a rank holds its own
    with pytest.raises(ValueError, match="unknown mesh axis"):
        convert.table_shards(jidx.meta_dict(), jidx.table, "data", 2)


def test_svm_head_predicts_indices_like_the_jax_head_on_float32_scores(indices):
    _, idx, _ = indices[40]
    jhead, head = _heads(idx, n_labels=6)
    x = np.random.default_rng(1).random((200, 40), dtype=np.float32).round(2)
    got = head.predict_indices(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jhead.predict_indices(x)))
    assert head.predict(x[:5]) == jhead.predict(x[:5])


# ------------------------------------------------------------------ real processes (gloo)

WORKER = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, os.environ["XS_ROOT"])
    import numpy as np
    from xspect2_tpu_torch import convert
    from xspect2_tpu_torch.parallel import (
        BlockShardedClassifier, ShardedClassifier, distributed, make_block_mesh, make_mesh,
    )

    cfg = json.loads(os.environ["XS_CFG"])
    rank = int(os.environ["XS_RANK"])
    topo = distributed.initialize(
        coordinator_address=os.environ["XS_COORD"], num_processes=cfg["world"],
        process_id=rank, device="cpu", timeout_s=60,
    )
    assert topo == {"process_index": rank, "process_count": cfg["world"],
                    "local_devices": 1, "global_devices": cfg["world"]}, topo
    data = np.load(os.environ["XS_IN"], allow_pickle=False)
    idx = convert.index_from_arrays(json.loads(str(data["meta"])), data["table"])
    head = None
    if cfg["head"]:
        head = convert.svm_head_from_arrays(
            data["sv"], data["dual"], data["intercept"], data["n_support"],
            [str(c) for c in data["classes"]], "rbf", float(data["gamma"]),
        )
    blk = cfg["axis"] == "blk"
    mesh = (make_block_mesh if blk else make_mesh)(*cfg["mesh"], device="cpu")
    assert mesh.coords == (rank // cfg["mesh"][1], rank % cfg["mesh"][1])
    cls = BlockShardedClassifier if blk else ShardedClassifier
    clf = cls(idx, mesh, svm_head=head, chunk=512, replicate_out=cfg["replicate_out"])
    reads = data["reads"]
    out = {}
    if cfg["replicate_out"] is None:
        out["hits"] = clf.count_hits_reads(reads, step=cfg["step"], reads_per_chunk=8)
        records = [(f"r{i}", reads[i][: 40 + 5 * i]) for i in range(len(reads))]
        per_record, totals, prediction = clf.classify(records, step=cfg["step"])
        out["record_hits"] = np.array([list(per_record[name].values()) for name, _ in records])
        out["totals"] = np.array(list(totals.values()), dtype=np.float32)
        out["prediction"] = np.array(str(prediction))
    else:
        local, row_start = clf.count_hits_reads(reads, step=cfg["step"], reads_per_chunk=8)
        out["local"], out["row_start"] = local, np.array(row_start)
        n_data = cfg["mesh"][0]
        per = len(reads) // n_data
        mine = reads[mesh.coords[0] * per : (mesh.coords[0] + 1) * per]
        out["host_sharded"] = clf.count_hits_reads_local(mine, step=cfg["step"], reads_per_chunk=8)
    np.savez(os.environ["XS_OUT"] + f".{rank}.npz", **out)
    print(json.dumps({"ok": True, "rank": rank}))
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_gloo_world(tmp_path, cfg, jidx, reads, jhead=None):
    """Run the worker in ``cfg["world"]`` processes joined by gloo; every
    process is killed after 100 s at the latest.  Returns each rank's
    saved arrays."""
    arrays = dict(meta=np.array(json.dumps(jidx.meta_dict())), table=jidx.table, reads=reads)
    if jhead is not None:
        arrays.update(
            sv=jhead.support_vectors, dual=jhead.dual_coef, intercept=jhead.intercept,
            n_support=jhead.n_support, classes=np.array(jhead.classes), gamma=np.array(jhead.gamma),
        )
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ)
    env.update(
        XS_ROOT=str(ROOT), XS_COORD=f"127.0.0.1:{_free_port()}", XS_IN=str(tmp_path / "in.npz"),
        XS_OUT=str(tmp_path / "out"), XS_CFG=json.dumps(cfg | {"head": jhead is not None}),
        OMP_NUM_THREADS="1",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env | {"XS_RANK": str(rank)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(cfg["world"])
    ]
    failures = []
    try:
        for rank, p in enumerate(procs):
            try:
                stdout, stderr = p.communicate(timeout=100)
            except subprocess.TimeoutExpired:
                failures.append(f"rank {rank}: timeout")
                continue
            if p.returncode != 0:
                failures.append(f"rank {rank} failed:\n{stdout}\n{stderr}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not failures, "\n".join(failures)
    return [np.load(tmp_path / f"out.{rank}.npz") for rank in range(cfg["world"])]


def _assert_world_equals_jax(outs, jclf, reads, step):
    want = jclf.count_hits_reads(reads, step=step, reads_per_chunk=RPC)
    records = [(f"r{i}", reads[i][: 40 + 5 * i]) for i in range(len(reads))]
    j_per_record, j_totals, j_prediction = jclf.classify(records, step=step)
    for out in outs:  # every rank holds the full, identical result
        np.testing.assert_array_equal(out["hits"], want)
        np.testing.assert_array_equal(
            out["record_hits"], np.array([list(j_per_record[name].values()) for name, _ in records]))
        np.testing.assert_array_equal(
            out["totals"].view(np.uint32),
            np.array(list(j_totals.values()), dtype=np.float32).view(np.uint32))
        assert str(out["prediction"]) == str(j_prediction)


def test_two_gloo_processes_cls_sharded_equal_the_jax_classifier(indices, tmp_path):
    jidx, idx, genomes = indices[64]
    jhead, _ = _heads(idx)
    reads = _reads(genomes, seed=11, n=13)
    cfg = dict(world=2, axis="cls", mesh=[1, 2], step=1, replicate_out=None)
    outs = _run_gloo_world(tmp_path, cfg, jidx, reads, jhead)
    _assert_world_equals_jax(outs, JaxSharded(jidx, jax_make_mesh(1, 2), svm_head=jhead, chunk=CHUNK), reads, 1)


def test_four_gloo_processes_blk_sharded_equal_the_jax_classifier(indices, tmp_path):
    jidx, idx, genomes = indices[8]
    jhead, _ = _heads(idx)
    reads = _reads(genomes, seed=12, n=13)
    cfg = dict(world=4, axis="blk", mesh=[2, 2], step=2, replicate_out=None)
    outs = _run_gloo_world(tmp_path, cfg, jidx, reads, jhead)
    _assert_world_equals_jax(
        outs, JaxBlockSharded(jidx, jax_make_block_mesh(2, 2), svm_head=jhead, chunk=CHUNK), reads, 2)


def test_gloo_local_rows_and_host_sharded_input(indices, tmp_path):
    """replicate_out=False: each rank returns its data shard's rows with
    their global offset (padding trimmed), and count_hits_reads_local
    takes each data shard's own reads."""
    jidx, idx, genomes = indices[40]
    reads = _reads(genomes, seed=13, n=20)  # 20 reads pad to 32: the tail shard trims 12 rows
    cfg = dict(world=4, axis="cls", mesh=[2, 2], step=1, replicate_out=False)
    outs = _run_gloo_world(tmp_path, cfg, jidx, reads)
    want = JaxSharded(jidx, jax_make_mesh(2, 2), chunk=CHUNK).count_hits_reads(reads, reads_per_chunk=RPC)
    for rank, out in enumerate(outs):
        d = rank // 2
        assert int(out["row_start"]) == 16 * d
        np.testing.assert_array_equal(out["local"], want[16 * d : 16 * (d + 1)])
        np.testing.assert_array_equal(out["host_sharded"], want[10 * d : 10 * (d + 1)])
    assert len(outs[0]["local"]) == 16 and len(outs[2]["local"]) == 4
