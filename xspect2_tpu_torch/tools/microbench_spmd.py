"""The sharded (data x cls) program's overhead against the single engine.

The port of the JAX package's ``tools/microbench_spmd.py``, which runs
the ``ShardedClassifier`` program on 8 virtual XLA devices of one host
CPU: the same total work on the same silicon, so with no overhead
(padding, per-shard dispatch, the merge) the sharded wall time would
equal the single-device query's.  Here one device runs every coordinate
of each mesh in turn: each coordinate's step (its data shard of the
reads through the packed wire, K1, and K2 on its class-word shard of the
table) is ``ShardedClassifier._local_reads_step`` on a mesh without
process groups, and the class shards are merged by concatenation, the
all_gather over ``cls`` done by hand (``every_coordinate``, which also
walks a (data x blk) mesh and sums its partial counts).  The gap to the single engine
(``DeviceQueryEngine.count_hits_reads``, the raw wire, K2) bounds what
the mesh program adds on one card; no collective runs::

    python -m xspect2_tpu_torch.tools.microbench_spmd

The same index (64 classes of 100 kbp, h = 7, seed 0) and 32,768 reads
as the JAX tool, whose printed lines it keeps.  ``--device cpu`` runs the
plain versions (a check, not a measurement).
"""

import argparse
import sys
import time

import numpy as np
import torch

from xspect2_tpu_torch import native, resolve_device
from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.ops.query import DeviceQueryEngine
from xspect2_tpu_torch.parallel import ShardedClassifier
from xspect2_tpu_torch.parallel.mesh import CLS_AXIS, DATA_AXIS, Mesh
from xspect2_tpu_torch.tools._synthetic import log

MESHES = ((4, 2), (8, 1))


def build(num_classes=64, genome_len=100_000, num_reads=32768, k=21, seed=0):
    """The JAX tool's index and reads from ``default_rng(seed)``:
    ``(index, reads uint8 [num_reads, 150])``."""
    rng = np.random.default_rng(seed)
    genomes = rng.integers(0, 4, size=(num_classes, genome_len), dtype=np.uint8)
    index = BlockedBitSlicedIndex.create(k, [str(i) for i in range(num_classes)], genome_len, fpr=0.01, num_hashes=7)
    for ci in range(num_classes):
        if native.available():
            native.insert_kmers(index, ci, genomes[ci])
        else:
            hi, lo, v = dna.canonical_kmers(genomes[ci], k)
            index.insert_kmers(ci, hi, lo, v)
    cls = rng.integers(0, num_classes, size=num_reads)
    pos = rng.integers(0, genome_len - 150, size=num_reads)
    reads = genomes[cls[:, None], pos[:, None] + np.arange(150)[None, :]].astype(np.uint8)
    return index, reads


def coordinate_mesh(n_data: int, n_model: int, device, axis: str = CLS_AXIS) -> Mesh:
    """A (data x ``axis``) mesh on one device without process groups: only
    the per-coordinate steps can run on it."""
    return Mesh({DATA_AXIS: n_data, axis: n_model}, (0, 0), {DATA_AXIS: None, axis: None}, device)


def merge_model(clf, parts: list) -> torch.Tensor:
    """The model-axis collective by hand: concatenate the class axis over
    ``cls``, sum over ``blk``."""
    if clf.model_axis == CLS_AXIS:
        return torch.cat(parts, dim=-1)
    return torch.stack(parts).sum(dim=0, dtype=torch.int32)


def every_coordinate(clf, reads: np.ndarray, reads_per_chunk: int) -> torch.Tensor:
    """Every coordinate's reads step in turn, merged over the model axis
    and the data shards stacked: int32 [rows, C_pad] on the device."""
    rows = []
    for d in range(clf.n_data):
        parts = [clf._local_reads_step((d, m), reads, 1, reads_per_chunk)[0] for m in range(clf.n_model)]
        rows.append(merge_model(clf, parts))
    return torch.cat(rows)


def run(num_classes=64, genome_len=100_000, num_reads=32768, reads_per_chunk=2048, iters=3, meshes=MESHES,
        device=None, repeats=1) -> dict:
    """The single engine, then each mesh: reads/s, the overhead, and the
    counts (all equal, or ``AssertionError`` as in the JAX tool).  With
    ``repeats`` > 1 the single engine and the meshes are timed in turn
    ``repeats`` times (``iters`` calls a window); each rate is the median
    window's, each overhead the median of the repeats' overheads, with
    their ranges beside them."""
    device = resolve_device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (plain versions)"
    log(f"one device, {name}: every coordinate of each mesh runs in turn on it")
    index, reads = build(num_classes, genome_len, num_reads)
    n = reads.shape[0]
    engine = DeviceQueryEngine(index, device=device)
    calls = {"single": lambda: engine.count_hits_reads(reads, reads_per_chunk=reads_per_chunk, wire="raw")}
    for n_data, n_cls in meshes:
        clf = ShardedClassifier(index, coordinate_mesh(n_data, n_cls, device))
        calls[f"{n_data}x{n_cls}"] = lambda clf=clf, n_data=n_data: clf._fetch(
            every_coordinate(clf, reads, reads_per_chunk // n_data), n)
    outs = {key: fn() for key, fn in calls.items()}  # warm: uploads every shard
    seconds = {key: [] for key in calls}
    for _ in range(repeats):
        for key, fn in calls.items():
            t0 = time.time()
            for _ in range(iters):
                fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds[key].append((time.time() - t0) / iters)

    single = outs["single"]
    t_single = float(np.median(seconds["single"]))
    print(f"single-device        : {n / t_single:,.0f} reads/s")
    res = {"index": index, "reads": reads, "single": single, "single_reads_per_s": n / t_single,
           "single_reads_per_s_range": (n / max(seconds["single"]), n / min(seconds["single"])),
           "iters": iters, "repeats": repeats, "seconds": seconds, "meshes": {}}
    for n_data, n_cls in meshes:
        key = f"{n_data}x{n_cls}"
        sharded = outs[key]
        t_shard = float(np.median(seconds[key]))
        print(f"sharded mesh {n_data}x{n_cls} (SPMD): {n / t_shard:,.0f} reads/s")
        if not np.array_equal(single, sharded):
            raise AssertionError("sharded result mismatch")
        overheads = [(ts / t1 - 1) * 100 for ts, t1 in zip(seconds[key], seconds["single"])]
        overhead = float(np.median(overheads))
        print(f"  overhead vs single-device program: {overhead:+.1f}% (same total work, same silicon)")
        res["meshes"][key] = {"counts": sharded, "reads_per_s": n / t_shard, "overhead_pct": overhead,
                              "overhead_pct_range": (min(overheads), max(overheads))}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
