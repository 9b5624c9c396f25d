#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels and the native host library from the
sources in the checkout, checks each kernel against its plain PyTorch
version on the card, then drives the port's paths end to end at full
width:

- reads: simulated FASTQ runs through ``xspect2_tpu_torch.classify``,
  an 8-class species model over 4 Mbp genomes and a 1-class genus model
  over 32 Mbp, 400,000 150 bp reads each (kernels K1 and K2); the species
  reads again through ``pipelines.run_read_benchmark`` inside
  ``profiling.trace``, whose trace must show K1 and K2 and gives the
  device's busy share;
- records: a 40-class x 4 Mbp SVM species model and the genus model
  over their 160 Mbp metagenome trained through
  ``train.train_from_directory(meta=True)`` (the SVM scoring runs K4,
  K3), ``classify_genus`` with that genus model on assemblies of two
  class genomes, then ``classify_species`` on 20 held-out draft
  assemblies (4 Mbp, 20-400 contigs) at steps 1 and 4, the same
  assemblies through ``pipelines.run_assembly_benchmark``, one of them
  through the CLI (``python -m xspect2_tpu_torch.main``, its own process)
  and the web app (werkzeug's test client) where click, werkzeug and
  cheroot import, and ``classify_genus`` on assemblies of the genus
  genome (K4, K3);
- validation: ``classify_species(..., validation=True)`` on a FASTQ of
  66,050 150 bp reads of three classes, each class's genome seeded as
  its reference under the misclassification directory: the records
  route (K4, K3), then the mapping post-filter on the host, which must
  move exactly the group drawn from one 30 kbp window; every read's hits
  equal the reads route's (K1, K2);
- MLST: a 7-locus x 1,000-allele x 450 bp scheme (k=31, fpr 0.001, one
  hash) trained through ``ProbabilisticFilterMlstSchemeModel.fit``, then
  ``classify_mlst`` on a FASTA of 4 Mbp genomes with one known allele
  per locus and a few short records (K4, K5, K6);
- xxh3 genus: the compat genus model fitted on the 32 Mbp genus genome,
  then ``classify_genus`` on assemblies drawn from it and on a FASTQ of
  100,000 reads (K4 and K7, which hashes on the card: one launch per
  record batch); the filter's own count API on sampled contigs (host
  hashing, the position-based K7), which is also timed on the longest
  contig's k-mers, as many non-members, a filter of 17 probes and random
  filters of 8-64 MB;
- sharded: ``xspect2_tpu_torch.parallel`` on the same tables and reads.
  The machine has one card, so every shard of each (data x blk) and
  (data x cls) mesh is evaluated in turn on it (K1-K4, K2 and K3 in
  their owned-block mode) and combined by hand, which must give the
  single engine's counts exactly; then both classifiers run through
  their public methods on a 1x1 mesh with NCCL at world size 1;
- the probe-select microbenchmark
  (``xspect2_tpu_torch.tools.microbench_probe``) at its default shape (K8);
- the shipped product path: the port's ``tools/demo_e2e.py`` on the card
  with 4 Mbp genomes and 200,000 reads (``models train directory --meta``:
  K4, K3; ``all``: K1, K2 in the genus filter and the species step); then,
  each held byte for byte against the same step with ``--device cpu``:
  ``all``, ``filter genus`` and ``filter species`` on 6,000 of its reads,
  ``models train mlst`` and ``models train ncbi`` from a loopback mock of
  PubMLST and NCBI (K4, K3), ``all`` with its MLST step on contigs of the
  demo's 470 genome (K4, K5, K6), ``pipelines.train_pangenome`` and
  ``grid_search_model``, and ``classify species`` with
  ``XSPECT_NO_NATIVE=1`` in a subprocess (K4, K3 instead of K1, K2, with
  the reads/s of both routes); no connection may leave 127.0.0.1;
- the card's memory regimes and the layout picker's constants: the
  fused row gather (K9) against its plain version, then the port's
  ``tools/recalibrate_constants.py`` at its defaults and at a scan across
  the 50 MB L2 (K9; K1 and K2 in its engine A/B), the gather grid, sorted
  gather and split tools (K9), the block-shard tool on the 40-class table
  (K2 and its owned-block mode; the shards' counts must sum to the whole
  table's), the fields tool (K2, K9), and ``pick_num_hashes`` under the
  printed budgets for every geometry above, with the species genomes
  fitted once more under the scan's budget and K2 timed at both indices
  on the species reads;
- the read query's body formulations and the mesh overhead: the seven
  body variants (K10) against their plain versions at 1, 2 and 4 class
  words and h = 1, 3 and 7, the counting ones against K2; the port's
  ``tools/microbench_body.py`` at its defaults (a 50 MB table) and at
  100 MB, each variant timed beside its bound and beside K2 on the same
  table and reads; the port's ``tools/microbench_spmd.py`` (64 classes,
  32,768 reads: the single engine, then every coordinate of the 4x2 and
  8x1 (data x cls) meshes in turn, K1 and K2, counts equal);
- the SVM species head (K11, one launch a prediction on the card, one an
  assembly on the records path): against its plain version for each
  kernel type at the main path's head and on a 512-class head (phase 2),
  then timed at the main path's head beside its plain version and an
  empty launch of one block, and held against the CPU's head on
  rows with a decision near zero (phase 6b).

It checks the results against the host reference, checks which kernels
each path launched, times each kernel against its bound and its plain
version (a call's time between CUDA events, ``ms``, and the kernels' own
time with no host work between them, ``device_ms``: calls captured in a
CUDA graph and replayed), and prints one JSON line per the contract below
as its last line:

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

It uses one card, the first visible one.  It exits non-zero, printing
no result, when CUDA is absent, when the port cannot be imported, or
when any phase fails.  Everything it writes goes to
``build/chip_smoke/`` (``build/`` is ignored by git).
"""

import argparse
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager, redirect_stdout
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
K = 21
READ_LEN = 150
NUM_READS = 400_000
SAMPLE = 2_000
# records path: the reference-scale species geometry (bench.py,
# species-40class-reference-scale), 40 classes x 4 Mbp
ASM_CLASSES = 40
GENOME_LEN = 4_000_000
SVM_LEN = 1_000_000  # SVM training assemblies are cut to this stretch
HELD_OUT = 20
GENUS_ASSEMBLIES = 4
# MLST: the scheme of tools/bench_mlst.py; depth is cut in the genome count
MLST_K = 31
MLST_LOCI = 7
MLST_ALLELES = 1000
ALLELE_LEN = 450
MLST_GENOMES = 8
MLST_SHORT = 3
# validation: a FASTQ of one class's reads, a group of another class's
# reads from one window, and a group of a third class's reads spread
# evenly over its genome
VAL_MAJORITY = 60_000
VAL_CLUSTERED = 3_000
VAL_WINDOW = 30_000
VAL_SPREAD = 3_050
META_ASSEMBLIES = 2
# xxh3 genus: assemblies and reads classified through the compat model
XXH3_ASSEMBLIES = 2
XXH3_READS = 100_000
# product path: the port's tools/demo_e2e.py at the species headline's
# genome size (bench.py geometry), then the CLI's other commands and the
# pipelines, each against the same command on the CPU
DEMO_GENOME_MB = 4.0
DEMO_READS = 200_000
PRODUCT_PARITY_READS = 6_000
PRODUCT_LOCI = 7
PRODUCT_ALLELES = 100
PRODUCT_CONTIG_LEN = 100_000
PANGENOME_GENERA = ("Alphus", "Betus")
PANGENOME_SPECIES = 3
PANGENOME_GENOME_LEN = 300_000
PRODUCT_SEED = 12
PRODUCT_UUID = (re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}"),
                re.compile(rb"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}"))
# kernel wrapper -> (source, the TPU program it replaces)
KERNELS = {
    "unpack_2bit": ("xspect2_tpu_torch/csrc/unpack_2bit.cu", "xspect2_tpu/ops/query.py:751"),
    "reads_query": ("xspect2_tpu_torch/csrc/reads_query.cu", "xspect2_tpu/ops/query.py:624"),
    "records_wire": ("xspect2_tpu_torch/csrc/records_wire.cu", "xspect2_tpu/ops/query.py:293"),
    "records_query": ("xspect2_tpu_torch/csrc/records_query.cu", "xspect2_tpu/ops/query.py:470"),
    "multi_records_query": ("xspect2_tpu_torch/csrc/multi_records_query.cu", "xspect2_tpu/ops/query.py:854"),
    "reduce_record_counts": ("xspect2_tpu_torch/csrc/segment_reduce.cu", "xspect2_tpu/ops/query.py:909"),
    "bloom_count": ("xspect2_tpu_torch/csrc/bloom_count.cu", "xspect2_tpu/core/compat.py:205"),
    "xxh3_records_count": ("xspect2_tpu_torch/csrc/xxh3_bloom.cu", "xspect2_tpu/core/compat.py:205"),
    "probe_select": ("xspect2_tpu_torch/csrc/probe_select.cu", "tools/microbench_pallas.py:74"),
    "row_gather": ("xspect2_tpu_torch/csrc/row_gather.cu", "tools/recalibrate_constants.py:50"),
    "body_variants": ("xspect2_tpu_torch/csrc/body_variants.cu", "tools/microbench_body.py:106"),
    "svm_head": ("xspect2_tpu_torch/csrc/svm_head.cu", "xspect2_tpu/models/svm_head.py:104"),
}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, the granule of a
# random HBM read, and the 32-bit non-tensor rate, above which the
# integer work of these kernels cannot run
HBM_BYTES_PER_S = 3.35e12
SECTOR_BYTES = 32
INT_OPS_PER_S = 67e12
# NVLink to the other cards of a host, each way (same data sheet): the rate
# a collective between cards cannot beat
NVLINK_BYTES_PER_S = 450e9
# estimated integer operations of a window (K2, K3, K5): ~30 to pack and
# canonicalize it from the codes staged 2-bit packed in shared memory, ~60
# to hash it; per table ~10 for its block and row addresses and 3 per probe
# word.  K7 (records route): ~30 to pack, ~50 for the ASCII words, ~40 for
# XXH3 (64-bit products count as several 32-bit operations) a window, and
# ~25 a probe for its 64-bit multiply-add, reduction and bit test.
WINDOW_OPS = 90
TABLE_OPS = 10
XXH3_OPS = 120
PROBE64_OPS = 25
# replays of a captured graph of calls in a device-only time
GRAPH_REPLAYS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of a call of ``fn`` over ``reps`` calls back to
    back between two CUDA events, after one warm-up unless ``warm`` is
    False: the call time, host work of the wrapper included where it
    outlasts the kernel."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> tuple[float | None, str]:
    """Device-only milliseconds of a call of ``fn`` and how they were
    taken: ``reps`` calls captured in one CUDA graph, its replays timed
    between CUDA events ("graph"), so no host work lies between the
    kernels; where the calls cannot be captured, the kernels' durations
    in a ``torch.profiler`` trace ("profiler"); else ``(None, "not
    measured")``."""
    fn()
    torch.cuda.synchronize()
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GRAPH_REPLAYS):
            graph.replay()
        end.record()
        end.synchronize()
        del graph
        return start.elapsed_time(end) / (GRAPH_REPLAYS * reps), "graph"
    except RuntimeError as exc:
        log(f"  device_ms: the calls cannot be captured in a CUDA graph ({str(exc)[:120]}); profiler")
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return (us / 1e3 / reps, "profiler") if us else (None, "not measured")


def timed(fn, reps: int) -> dict:
    """The call time (``ms``) and the device-only time (``device_ms``,
    ``device_by``) of ``fn``."""
    ms = cuda_ms(fn, reps)
    dev, by = device_ms(fn, reps)
    return dict(ms=ms, device_ms=dev, device_by=by)


def ms_text(t: dict) -> str:
    dev = "not measured" if t["device_ms"] is None else f"{t['device_ms']:.4f} ms"
    return f"{t['ms']:.4f} ms a call, {dev} device-only ({t['device_by']})"


@contextmanager
def stopwatch(owner, attr: str, seconds: dict, key: str):
    """While active, every call of ``owner.attr`` (a function of a module
    or of a class) adds its host-clock seconds to ``seconds[key]``."""
    inner = getattr(owner, attr)

    def timed_call(*args, **kwargs):
        t0 = time.time()
        try:
            return inner(*args, **kwargs)
        finally:
            seconds[key] = seconds.get(key, 0.0) + time.time() - t0

    setattr(owner, attr, timed_call)
    try:
        yield
    finally:
        setattr(owner, attr, inner)


def pin_one_card() -> str:
    """Make this process see only the first visible card, so the device
    count it reports is the one card it used.  Returns that card's
    ``nvidia-smi`` index (or UUID)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card = "0" if visible is None else visible.split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    return card


def card_line(card: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0].strip()


def wrapper(name: str):
    """The kernel wrapper ``name``, which carries the launch count."""
    from xspect2_tpu_torch.ops import bloom, body_variants, probe_select, query, row_gather, svm_head

    module = {"bloom_count": bloom, "xxh3_records_count": bloom, "probe_select": probe_select,
              "row_gather": row_gather, "body_variants": body_variants, "svm_head": svm_head}.get(name, query)
    return getattr(module, name)


def reset_launches() -> None:
    for name in KERNELS:
        wrapper(name).launches = 0


def read_launches() -> dict:
    return {name: wrapper(name).launches for name in KERNELS}


def add_launches(total: dict, more: dict) -> None:
    for name, v in more.items():
        total[name] += v


def probe_sectors(idx, hi, lo, seen) -> int:
    """The 32 B sectors of the table that the probes of the canonical
    k-mers ``(hi, lo)`` (int64 on the card) read, as K2, K3 and K5
    address the row-major table (``ops.query.table_tensor``): probe row
    ``r`` of block ``b`` is the ``class_words`` words from
    ``(b * rows_per_block + r) * class_words`` on.  Marks each sector in
    ``seen`` (one bool per sector of the table) and returns the sum over
    k-mers of the distinct sectors each reads."""
    from xspect2_tpu_torch.core.hashing import MASK32, kmer_hash_words_torch

    a, b, c = kmer_hash_words_torch(hi, lo)
    rpb, cw = idx.rows_per_block, idx.class_words
    words_per_sector = SECTOR_BYTES // 4
    i = torch.arange(idx.num_hashes, dtype=torch.int64, device=hi.device)
    rows = ((b[:, None] + i * c[:, None]) & MASK32) & (rpb - 1)
    first = ((a % idx.num_blocks)[:, None] * rpb + rows) * cw  # [n, h]
    # the sectors of a row run from its first word's to its last word's
    t = torch.arange((cw + words_per_sector - 2) // words_per_sector + 1, device=hi.device)
    sectors = torch.minimum(first[:, :, None] // words_per_sector + t,
                            (first[:, :, None] + cw - 1) // words_per_sector)
    sectors = sectors.reshape(len(hi), -1).sort(dim=1).values
    seen[sectors.reshape(-1)] = True
    return len(sectors) + int((sectors[:, 1:] != sectors[:, :-1]).sum())


def table_sectors(idx) -> torch.Tensor:
    """One bool per 32 B sector of the index's device table, all False."""
    words = idx.num_blocks * idx.class_words * idx.rows_per_block
    return torch.zeros(words * 4 // SECTOR_BYTES, dtype=torch.bool, device="cuda")


# ---------------------------------------------------------------- phase 1


def build_all() -> dict:
    """Phase 1: every kernel library and the native library; returns each
    kernel library's compiler output (``-Xptxas -v``)."""
    from xspect2_tpu_torch import native
    from xspect2_tpu_torch.ops import _kernels

    t0 = time.time()
    make = subprocess.Popen(
        ["make", "-C", str(ROOT / "native")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        logs = _kernels.build()
    finally:
        make_log, _ = make.communicate(timeout=600)
    require(make.returncode == 0, f"make -C native failed:\n{make_log}")
    require(native.available(), "the native host library does not load")
    secs = time.time() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"build: {len(logs)} kernels and the native library in {secs:.1f} s")
    return logs


# ---------------------------------------------------------------- phase 2


def random_index(num_classes, num_hashes, rng, num_kmers=200_000):
    """An index geometry with random table words (every bit set w.p. 1/2)."""
    from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex

    idx = BlockedBitSlicedIndex.create(
        K, [f"c{i}" for i in range(num_classes)], num_kmers, num_hashes=num_hashes
    )
    idx.table[:] = rng.integers(0, 2**32, size=idx.table.size, dtype=np.uint64).astype(np.uint32)
    return idx


def check_kernels(rng, errors):
    """Each kernel equals its plain version on the card, exactly."""
    from xspect2_tpu_torch.ops import query

    cases = [  # (classes, num_hashes, read_len, step); K2 stages its reads' codes,
        # so also read lengths that are not multiples of 16, steps 1-5 and
        # reads longer than the 2,048-position stage
        (8, 2, 150, 1), (8, 2, 300, 4), (1, 3, 150, 2), (1, 3, 300, 1),
        (40, 7, 300, 1), (40, 7, 150, 2), (512, 3, 150, 4), (512, 3, 300, 2),
        (8, 2, 133, 3), (1, 3, 157, 5), (40, 7, 99, 4), (512, 3, 251, 5),
        (8, 2, 2100, 1), (1, 3, 2100, 3), (40, 7, 5003, 2), (512, 3, 2049, 5),
    ]
    dev = torch.device("cuda")
    for num_classes, h, read_len, step in cases:
        idx = random_index(num_classes, h, rng)
        n = 3000 if read_len <= 300 else 200
        n_pad = n + 72  # 72 padding rows, poisoned by the wire
        reads = rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)
        reads[rng.integers(0, n, 40), rng.integers(0, read_len, 40)] = 255
        wire = query.wire_to_device(query.pack_reads_wire(reads, K, n_pad), dev)
        require(int((wire[1] >= n_pad).sum()) > 0, "the patch list carries no sentinel")
        codes = query.unpack_2bit(*wire, read_len)
        plain_codes = query.unpack_2bit_plain(*wire, read_len)
        # the same list shuffled (the patch-only launch), and no list at all
        perm = torch.from_numpy(rng.permutation(wire[1].numel())).to(dev)
        shuffled = query.unpack_2bit(wire[0], wire[1][perm], wire[2][perm], read_len)
        none = wire[1][:0]
        bare = query.unpack_2bit(wire[0], none, none, read_len)
        errors["unpack_2bit"] = max(
            errors["unpack_2bit"], int((codes.int() - plain_codes.int()).abs().max()),
            int((shuffled.int() - plain_codes.int()).abs().max()),
            int((bare.int() - query.unpack_2bit_plain(wire[0], none, none, read_len).int()).abs().max()),
        )
        table = query.table_tensor(idx, dev)
        geom = dict(
            k=K, step=step, num_blocks=idx.num_blocks, rows_per_block=idx.rows_per_block,
            class_words=idx.class_words, num_hashes=idx.num_hashes,
            fields_per_word=idx.fields_per_word, num_classes=idx.num_classes,
        )
        got = query.reads_query(codes, table, **geom).long()
        want = query.reads_query_plain(codes, table, **geom).long()
        err = int((got - want).abs().max())
        errors["reads_query"] = max(errors["reads_query"], err)
        require(int(got[n:].sum()) == 0, "padding rows counted hits")
        log(
            f"  kernels vs plain: C={num_classes} P={idx.fields_per_word} h={h} "
            f"L={read_len} step={step}: max |err| {err}, hits {int(got.sum())}"
        )
    # K1 alone at reads shorter than 16 bases (codes built with a running
    # column) and longer than its 8,192-code tile (every tile starts and
    # ends inside a row)
    for read_len, k in ((5, 3), (10_001, K)):
        reads = rng.integers(0, 4, size=(300, read_len), dtype=np.uint8)
        reads[rng.integers(0, 300, 40), rng.integers(0, read_len, 40)] = 255
        wire = query.wire_to_device(query.pack_reads_wire(reads, k, 320), dev)
        err = int((query.unpack_2bit(*wire, read_len).int() - query.unpack_2bit_plain(*wire, read_len).int()).abs().max())
        errors["unpack_2bit"] = max(errors["unpack_2bit"], err)
        log(f"  unpack_2bit vs plain: L={read_len} k={k}, {wire[1].numel()} patch entries: max |err| {err}")
    require(errors["unpack_2bit"] == 0, "unpack_2bit disagrees with its plain version")
    require(errors["reads_query"] == 0, "reads_query disagrees with its plain version")



def check_multi_kernels(rng, errors):
    """K5, K6 and both K7 equal their plain versions on the card, exactly: K5
    over tables of three geometries in one call, one launch for each
    probe path (field-packed C=4, two class words, 32 class words), also
    against K3 per table, on the shared-counter and the global-atomic
    path; K6 in its three modes with
    thresholds 50 and -1 and segment ids outside the range; the
    position-based K7 against the host count of a filter with 7 probes; the
    records-route K7 against its plain version and the host count at k = 5,
    12, 21 and 31 (the three XXH3 length paths), on the shared-counter and
    the global-atomic path."""
    from xspect2_tpu_torch.core import compat, dna
    from xspect2_tpu_torch.ops import bloom, query

    dev = torch.device("cuda")
    indices = [random_index(c, h, rng, num_kmers=20_000) for c, h in ((4, 2), (40, 7), (1000, 1))]
    require([(i.fields_per_word > 1, i.class_words) for i in indices] == [(True, 1), (False, 2), (False, 32)],
            "the multi-index geometries are not field-packed, cw=2 and cw=32")
    engines = [query.DeviceQueryEngine(idx, device=dev) for idx in indices]
    tables = [e.table for e in engines]
    geoms = [e.geometry() for e in engines]
    genome = rng.integers(0, 4, size=300_000, dtype=np.uint8)
    # (records, length range, record-length hint): one record; a few;
    # many short ones with a hint that forces the global-atomic path
    for n_rec, lo, hi, hint in ((1, 450, 451, None), (6, 32, 5000, 32), (700, 22, 300, 22), (700, 22, 60, 10**6)):
        records = []
        for i in range(n_rec):
            n = int(rng.integers(lo, hi))
            at = int(rng.integers(0, len(genome) - n))
            c = genome[at : at + n].copy()
            if i % 5 == 0:
                c[rng.integers(0, n, 2)] = 255
            records.append((f"r{i}", c))
        batch = query.prepare_batch(records, K, chunk=engines[0].chunk)
        max_records = query._next_pow2(max(8, batch.num_records))
        inputs = [torch.from_numpy(a).to(dev) for a in (batch.codes, batch.rec_ids, batch.valid)]
        want = query.multi_records_query_plain(tables, geoms, *inputs, max_records=max_records)
        got = query.multi_records_query(tables, geoms, *inputs, max_records=max_records, min_record_len=hint)
        err5 = max(int((g - w).abs().max()) for g, w in zip(got, want))
        for e, w in zip(engines, want):
            single = query.records_query(*inputs, e.table, max_records=max_records, **e.geometry())
            err5 = max(err5, int((w - single).abs().max()))
        errors["multi_records_query"] = max(errors["multi_records_query"], err5)
        seg = np.sort(rng.integers(0, 5, size=max_records)).astype(np.int32)
        seg[rng.integers(0, max_records, 2)] = [-1, 9]  # outside [0, 5): add nothing
        seg_ids = torch.from_numpy(seg).to(dev)
        err6 = 0
        for mode in query.REDUCE_MODES:
            for threshold in (50, -1):
                red = query.reduce_record_counts(got, mode, threshold, seg_ids, 5)
                ref = query.reduce_record_counts_plain(want, mode, threshold, seg_ids, 5)
                err6 = max(err6, *(int((a - b).abs().max()) for a, b in zip(red, ref)))
        errors["reduce_record_counts"] = max(errors["reduce_record_counts"], err6)
        log(f"  multi-index kernels vs plain: {n_rec} records of {lo}-{hi} bp, hint {hint}, "
            f"max_records {max_records}: max |err| K5 {err5}, K6 {err6}, hits {[int(g.sum()) for g in got]}")
    require(errors["multi_records_query"] == 0, "multi_records_query disagrees with its plain version or with records_query")
    require(errors["reduce_record_counts"] == 0, "reduce_record_counts disagrees with its plain version")

    filt = compat.XXH3BloomFilter.for_items(len(genome) - K + 1, 0.01, K, device=dev)
    require(filt.num_hashes == 7, "the compat filter at fpr 0.01 does not take 7 probes")
    filt.insert_packed(*dna.canonical_kmers(genome, K))
    for n in (1, 5_000, 200_000):
        probe = np.concatenate([genome[: n // 2 + K], rng.integers(0, 4, size=n, dtype=np.uint8)])[: n + K - 1]
        probe[rng.integers(0, len(probe), 3)] = 255
        hi, lo, valid = dna.canonical_kmers(probe, K)
        host = filt.count_hits_host(hi, lo, valid)
        got = filt.count_hits_device(hi, lo, valid)
        words = torch.from_numpy(filt.words.view(np.int32)).to(dev)
        pos = torch.from_numpy(filt._positions(hi, lo, valid).astype(np.uint32).view(np.int32)).to(dev)
        plain = int(bloom.bloom_count_plain(words, pos, torch.from_numpy(valid).to(dev)))
        errors["bloom_count"] = max(errors["bloom_count"], abs(got - host), abs(got - plain))
        log(f"  bloom_count vs host and plain: {n} k-mers, h=7: kernel {got}, host {host}, plain {plain}")
    # h = 17 (groups of 8 probes) through the API and on a pos view 4 bytes
    # past an aligned start; h = 1 and 120 (positions read in place) on
    # random bits; drawn from a child of rng, so the later phases draw what they drew
    extra = rng.spawn(1)[0]
    f17 = compat.XXH3BloomFilter.for_items(len(genome) - K + 1, 2.0 ** -17, K, device=dev)
    require(f17.num_hashes == 17, "the compat filter at fpr 2^-17 does not take 17 probes")
    f17.insert_packed(*dna.canonical_kmers(genome, K))
    probe = np.concatenate([genome[: 100_000 + K], extra.integers(0, 4, size=100_000, dtype=np.uint8)])
    hi, lo, valid = dna.canonical_kmers(probe, K)
    mask = torch.from_numpy(valid).to(dev)
    for f in (filt, f17):
        host = f.count_hits_host(hi, lo, valid)
        api = f.count_hits_device(hi, lo, valid)
        pos = f._positions(hi, lo, valid).astype(np.uint32).view(np.int32)
        flat = torch.zeros(pos.size + 1, dtype=torch.int32, device=dev)
        flat[1:] = torch.from_numpy(pos.ravel()).to(dev)
        view = flat[1:].view(pos.shape)
        require(view.data_ptr() % 16 == 4, "the offset view does not start 4 bytes past a 16-byte boundary")
        got = int(bloom.bloom_count(f.device_words(), view, mask))
        plain = int(bloom.bloom_count_plain(f.device_words(), view, mask))
        errors["bloom_count"] = max(errors["bloom_count"], abs(api - host), abs(got - host), abs(got - plain))
        log(f"  bloom_count vs host and plain: {len(hi)} k-mers, h={f.num_hashes}, API and a view at +4 bytes: "
            f"kernel {api} and {got}, host {host}, plain {plain}")
    gen = torch.Generator(device=dev).manual_seed(int(extra.integers(1 << 31)))
    for h in (1, 120):
        words = torch.randint(-2**31, 2**31 - 1, (1 << 16,), dtype=torch.int32, device=dev, generator=gen)
        for _ in range(1 if h == 1 else 5):  # bits set w.p. 3/4, or 63/64 so that some k-mers hit
            words |= torch.randint(-2**31, 2**31 - 1, (1 << 16,), dtype=torch.int32, device=dev, generator=gen)
        pos = torch.randint(0, (32 << 16) + 4096, (20_001, h), dtype=torch.int32, device=dev, generator=gen)
        mask = torch.rand(20_001, device=dev, generator=gen) < 0.9
        got = int(bloom.bloom_count(words, pos, mask))
        plain = int(bloom.bloom_count_plain(words, pos, mask))
        errors["bloom_count"] = max(errors["bloom_count"], abs(got - plain))
        log(f"  bloom_count vs plain: 20,001 k-mers, h={h}, random bits, some positions past the filter: "
            f"kernel {got}, plain {plain}")
    require(errors["bloom_count"] == 0, "bloom_count disagrees with the host count or its plain version")

    for k in (5, 12, 21, 31):
        kfilt = compat.XXH3BloomFilter.for_items(len(genome) - k + 1, 0.01, k, device=dev)
        kfilt.insert_packed(*dna.canonical_kmers(genome, k))
        records = []
        for i in range(600):
            n = int(k + 1 + rng.pareto(1.0) * 60) if i % 7 else 5000
            n = min(n, 20_000)
            at = int(rng.integers(0, len(genome) - n))
            c = genome[at : at + n].copy() if i % 4 else rng.integers(0, 4, size=n, dtype=np.uint8)
            if i % 5 == 0:
                c[rng.integers(0, n, 2)] = 255
            records.append((f"r{i}", c))
        batch = query.prepare_batch(records, k, step=1 + k % 3)
        max_records = query._next_pow2(max(8, batch.num_records))
        codes, rec, valid = query.restore_records_wire(
            *query.upload_records_wire(batch, max_records, dev), batch.num_positions, k=k, step=batch.step)
        geom = dict(max_records=max_records, k=k, num_bits=kfilt.num_bits, num_hashes=kfilt.num_hashes)
        words = kfilt.device_words()
        want = bloom.xxh3_records_count_plain(words, codes, rec, valid, **geom)
        err = 0
        for hint in (k + 1, 10**6):  # 10**6: 2 counter rows, the global-atomic path
            got = bloom.xxh3_records_count(words, codes, rec, valid, min_record_len=hint, **geom)
            err = max(err, int((got - want).abs().max()))
        host = [kfilt.count_hits_host(*dna.canonical_kmers(c, k, step=batch.step)) for _, c in records[:60]]
        err = max(err, int(np.abs(got[:60].cpu().numpy() - host).max()))
        errors["xxh3_records_count"] = max(errors["xxh3_records_count"], err)
        log(f"  xxh3_records_count vs plain and host: k={k} step={batch.step}, {batch.num_records} records, "
            f"h={kfilt.num_hashes}: max |err| {err}, hits {int(got.sum())}")
    require(errors["xxh3_records_count"] == 0, "xxh3_records_count disagrees with its plain version or the host count")


# ---------------------------------------------------------------- phases 3-4


def simulate_reads(genomes, num_reads, rng):
    """150 bp reads from random classes and positions, half reverse
    complement, ~0.2% carrying one N."""
    num_classes, genome_len = genomes.shape
    cls = rng.integers(0, num_classes, size=num_reads)
    pos = rng.integers(0, genome_len - READ_LEN, size=num_reads)
    reads = genomes[cls[:, None], pos[:, None] + np.arange(READ_LEN)[None, :]]
    rc = rng.random(num_reads) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    reads = reads.astype(np.uint8)
    bad = rng.random(num_reads) < 0.002
    reads[bad, rng.integers(0, READ_LEN, size=int(bad.sum()))] = 255
    return reads, cls


def write_fastq(path: Path, reads: np.ndarray) -> None:
    """Fixed-width FASTQ records: @r%07d, sequence, +, quality."""
    n = len(reads)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = np.where(reads <= 3, lut[np.minimum(reads, 3)], ord("N")).astype(np.uint8)
    ids = np.frombuffer(
        "".join(f"@r{i:07d}\n" for i in range(n)).encode(), dtype=np.uint8
    ).reshape(n, 10)
    rec = np.concatenate(
        [
            ids, seq, np.full((n, 1), ord("\n"), np.uint8),
            np.frombuffer(b"+\n", np.uint8)[None].repeat(n, 0),
            np.full((n, READ_LEN), ord("I"), np.uint8), np.full((n, 1), ord("\n"), np.uint8),
        ],
        axis=1,
    )
    path.write_bytes(rec.tobytes())


def build_index(names, genomes):
    from xspect2_tpu_torch import native
    from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex

    t0 = time.time()
    idx = BlockedBitSlicedIndex.create(K, names, genomes.shape[1] - K + 1, fpr=0.01, num_hashes=None)
    for ci in range(len(names)):
        native.insert_kmers(idx, ci, genomes[ci])
    log(
        f"  index: C={idx.num_classes} h={idx.num_hashes} P={idx.fields_per_word} "
        f"{idx.num_blocks} blocks, {idx.nbytes / 1e6:.1f} MB, built in {time.time() - t0:.1f} s"
    )
    return idx


def host_counts(idx, reads):
    from xspect2_tpu_torch.core import dna

    rows = []
    for r in reads:
        hi, lo, valid = dna.canonical_kmers(r, K)
        rows.append(idx.count_hits_host(hi, lo, valid))
    return np.stack(rows)


def time_kernels(idx, reads, card, errors):
    """Both kernels on the main path's wire: time, bound, plain time."""
    from xspect2_tpu_torch.models.filter_model import _READS_PER_CHUNK
    from xspect2_tpu_torch.ops import query

    dev = torch.device("cuda")
    n = len(reads)
    engine = query.DeviceQueryEngine(idx, device=dev)
    wire = engine.upload_wire(reads, _READS_PER_CHUNK)  # as count_hits_reads builds it
    n_pad = wire[0].shape[0]
    geom = dict(step=1, **engine.geometry())

    codes = query.unpack_2bit(*wire, READ_LEN)
    plain_codes = query.unpack_2bit_plain(*wire, READ_LEN)
    errors["unpack_2bit"] = max(
        errors["unpack_2bit"], int((codes.int() - plain_codes.int()).abs().max())
    )
    got = query.reads_query(codes, engine.table, **geom)
    want = query.reads_query_plain(codes, engine.table, **geom)
    errors["reads_query"] = max(errors["reads_query"], int((got.long() - want.long()).abs().max()))
    require(errors["unpack_2bit"] == 0 and errors["reads_query"] == 0,
            "a kernel disagrees with its plain version at the main path's shape")

    k1 = timed(lambda: query.unpack_2bit(*wire, READ_LEN), 20)
    k1_plain = cuda_ms(lambda: query.unpack_2bit_plain(*wire, READ_LEN), 3)
    k2 = timed(lambda: query.reads_query(codes, engine.table, **geom), 10)
    k2_ms = k2["ms"]
    k2_plain = cuda_ms(lambda: query.reads_query_plain(codes, engine.table, **geom), 1)
    shape = f"[{n_pad}x{READ_LEN}], {wire[1].numel()} patch entries"

    k1_bytes = wire[0].numel() + 8 * wire[1].numel() + codes.numel()
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    b2 = reads_bound(idx, codes, got)
    valid, probes, window_sectors, run_sectors = b2["counted"], b2["probes"], b2["window_sectors"], b2["run_sectors"]
    k2_bytes_ms, k2_ops_ms, k2_reuse_free_ms = b2["bytes_ms"], b2["ops_ms"], b2["no_reuse_ms"]
    log(f"  timing [{card}] unpack_2bit {shape}: {ms_text(k1)}, bound {k1_bound:.4f} ms (bytes), "
        f"plain {k1_plain:.4f} ms")
    log(
        f"  timing [{card}] reads_query [{n_pad}x{READ_LEN}], {valid} windows probed x "
        f"{probes} words: {ms_text(k2)}, bound {max(k2_bytes_ms, k2_ops_ms):.4f} ms "
        f"(bytes {k2_bytes_ms:.4f} reading each of the {run_sectors} table sectors touched once, "
        f"operations {k2_ops_ms:.4f}), plain {k2_plain:.4f} ms"
    )
    log(
        f"  reads_query: {window_sectors} sectors summed over windows ({window_sectors / valid:.3f} "
        f"per window), {run_sectors} distinct over the run; bytes with no reuse between windows "
        f"{k2_reuse_free_ms:.4f} ms"
    )
    log(
        f"  device-side [{card}]: {n / ((k1['ms'] + k2_ms) / 1e3):.0f} reads/s "
        f"({n} reads, {n_pad} rows; unpack + query kernels, call times)"
    )
    return {
        "unpack_2bit": dict(k1, plain_ms=k1_plain, bound_ms=k1_bound, bound_by="bytes"),
        "reads_query": dict(
            k2, plain_ms=k2_plain, bound_ms=max(k2_bytes_ms, k2_ops_ms),
            bound_by="bytes" if k2_bytes_ms >= k2_ops_ms else "operations",
        ),
    }


def reads_bound(idx, codes, out):
    """K2's bound on uint8 reads ``codes`` [n, L] (int on the card) giving
    ``out``, at step 1: windows without an N reach the table and read their
    probe words, each 32 B sector they touch read once (bytes);
    WINDOW_OPS + TABLE_OPS a counted window (canonicalized from the staged
    codes and hashed) and 3 per probe word (operations).  ``idx`` needs
    the geometry attributes of an index."""
    from xspect2_tpu_torch.ops import query

    n, read_len = codes.shape
    nk = read_len - K + 1
    seen = table_sectors(idx)
    counted = window_sectors = 0
    for r0 in range(0, n, 32_768):
        hi, lo, bad = query._canonical_windows_plain(codes[r0 : r0 + 32_768].long(), K, nk)
        keep = ~bad
        counted += int(keep.sum())
        window_sectors += probe_sectors(idx, hi[keep], lo[keep], seen)
    run_sectors = int(seen.sum())
    probes = idx.num_hashes * (idx.class_words if idx.fields_per_word == 1 else 1)
    nbytes = codes.numel() + run_sectors * SECTOR_BYTES + out.numel() * out.element_size()
    no_reuse = nbytes + (window_sectors - run_sectors) * SECTOR_BYTES
    ops = counted * (WINDOW_OPS + TABLE_OPS + 3 * probes)
    return dict(bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / INT_OPS_PER_S * 1e3,
                no_reuse_ms=no_reuse / HBM_BYTES_PER_S * 1e3, counted=counted, probes=probes,
                window_sectors=window_sectors, run_sectors=run_sectors)


def time_reads_launch(label, idx, codes, table, geom, card) -> tuple[float, float]:
    """K2 at one more launch shape of the main path: ``(ms, bound_ms)``."""
    from xspect2_tpu_torch.ops import query

    out = query.reads_query(codes, table, **geom)
    ms = cuda_ms(lambda: query.reads_query(codes, table, **geom), 10)
    b = reads_bound(idx, codes, out)
    bound = max(b["bytes_ms"], b["ops_ms"])
    log(f"  timing [{card}] reads_query ({label}, {codes.shape[0]}x{codes.shape[1]}): {ms:.4f} ms, bound "
        f"{bound:.4f} ms (bytes {b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), "
        f"{b['window_sectors'] / max(1, b['counted']):.3f} sectors a window")
    return ms, bound


def run_path(kind, idx, genomes, rng, card):
    """Save a model, classify a FASTQ through the port's facade, check it."""
    from xspect2_tpu_torch import classify
    from xspect2_tpu_torch.definitions import get_xspect_model_path
    from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel
    from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel

    cls = ProbabilisticFilterModel if kind == "species" else ProbabilisticSingleFilterModel
    model = cls(K, "Smoke", None, None, kind.capitalize(), get_xspect_model_path(), device="cpu")
    model.index = idx
    model.display_names = {name: f"Smoke {name}" for name in idx.class_names}
    model.save()

    reads, src = simulate_reads(genomes, NUM_READS, rng)
    fastq = WORK / f"{kind}.fastq"
    write_fastq(fastq, reads)
    out = WORK / f"{kind}.json"
    facade = classify.classify_species if kind == "species" else classify.classify_genus

    reset_launches()
    t0 = time.time()
    facade("Smoke", fastq, out, device="cuda")
    e2e = time.time() - t0
    launches = read_launches()
    log(f"  {kind}: kernel launches on the reads path {launches}")
    require(
        launches["unpack_2bit"] == launches["reads_query"] > 0,
        f"{kind}: the reads path did not launch K1 once (the patches inside it) for each K2 launch",
    )
    require(
        launches["records_wire"] == launches["records_query"] == 0,
        f"{kind}: the reads path launched a records kernel",
    )
    log(f"  end-to-end [{card}] {kind}: {NUM_READS} reads in {e2e:.2f} s, {NUM_READS / e2e:.0f} reads/s")

    res = json.loads(out.read_text(encoding="utf-8"))
    hits = res["hits"]
    require(len(hits) == NUM_READS, f"{kind}: {len(hits)} records in the result")
    names = idx.class_names
    top = np.array([names.index(next(iter(hits[f"r{i:07d}"]))) for i in range(NUM_READS)])
    counts = np.array([[hits[f"r{i:07d}"][c] for c in names] for i in range(NUM_READS)])
    clean = (reads <= 3).all(axis=1)
    nk = READ_LEN - K + 1
    if kind == "species":
        frac = float((top == src).mean())
        log(f"  {kind}: {frac:.5f} of reads rank their source class first")
        require(frac >= 0.99, f"{kind}: only {frac} of reads rank their source class first")
    else:
        frac = float((counts[clean, 0] == nk).mean())
        log(f"  {kind}: {frac:.5f} of reads without an N hit every window")
        require(frac == 1.0, f"{kind}: a read without an N missed a window")
    sample = rng.choice(NUM_READS, size=SAMPLE, replace=False)
    require(
        np.array_equal(counts[sample], host_counts(idx, reads[sample])),
        f"{kind}: counts differ from the host reference",
    )
    log(f"  {kind}: {SAMPLE} sampled reads equal the host reference exactly")
    require(res["num_kmers"]["r0000000"] == nk, f"{kind}: wrong k-mer count")
    breakdown(cls, kind, fastq, card)
    return launches, reads, counts, src


def breakdown(cls, kind, fastq, card):
    """Host-clock seconds of each step of the path, each ending in a sync."""
    from xspect2_tpu_torch import native
    from xspect2_tpu_torch.model_management import metadata_path
    from xspect2_tpu_torch.models.filter_model import _READS_PER_CHUNK
    from xspect2_tpu_torch.ops import query

    model = cls.load(metadata_path(f"Smoke-{kind}"), device="cuda")
    model.engine  # noqa: B018 - uploads the table before timing
    torch.cuda.synchronize()
    t0 = time.time()
    codes, offsets, ids = native.parse_file(fastq)
    mat = codes.reshape(len(ids), -1)
    t1 = time.time()
    query.pack_reads_wire(mat, K, -(-len(mat) // _READS_PER_CHUNK) * _READS_PER_CHUNK)
    t2 = time.time()
    model._count_reads(mat, 1)
    t3 = time.time()
    res = model.predict(fastq)
    t4 = time.time()
    res.save(WORK / f"{kind}-breakdown.json")
    t5 = time.time()
    steps = {
        "parse": t1 - t0, "pack": t2 - t1, "count (pack, copy, kernels, fetch)": t3 - t2,
        "hit dicts": (t4 - t3) - (t3 - t0), "result JSON": t5 - t4,
    }
    log(f"  breakdown [{card}] {kind}, s: " + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()))


def trace_busy_share(trace_dir: Path, kernel_names) -> dict:
    """Parse the ``torch.profiler`` trace written into ``trace_dir``: the
    kernel events of each of ``kernel_names`` (substrings of the CUDA
    kernel names), and the device's busy share, the union of all kernel
    intervals over the traced window (the first event's start to the last
    event's end, host events included)."""
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    require(len(files) == 1, f"expected one trace file in {trace_dir}, found {len(files)}")
    events = json.loads(files[0].read_text(encoding="utf-8"))["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                     for e in spans if e.get("cat") == "kernel")
    found = {name: sum(name in k[2] for k in kernels) for name in kernel_names}
    require(all(found.values()), f"kernels missing from the trace: {found}")
    start = min(float(e["ts"]) for e in spans)
    end = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    busy, reach = 0.0, start
    for t0, t1, _ in kernels:
        if t1 > reach:
            busy += t1 - max(t0, reach)
            reach = t1
    memcpy = sum(float(e["dur"]) for e in spans if e.get("cat") == "gpu_memcpy")
    return dict(window_ms=(end - start) / 1e3, kernel_busy_ms=busy / 1e3, busy_share=busy / (end - start),
                memcpy_ms=memcpy / 1e3, kernel_events=len(kernels), found=found)


def run_read_benchmark_traced(idx, reads, src, counts, card):
    """``pipelines.run_read_benchmark`` on the species model and the phase's
    reads inside ``profiling.trace``: every read's prediction is the tie
    rule's argmax of the counts the facade gave (checked against the host
    on a sample above); K1 and K2 appear in the trace as kernel events;
    prints the device's busy share over the traced window and the
    engine's phases."""
    from xspect2_tpu_torch import pipelines, profiling
    from xspect2_tpu_torch.model_cache import load_cached
    from xspect2_tpu_torch.model_management import metadata_path
    from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel

    model = load_cached(ProbabilisticFilterModel, metadata_path("Smoke-species"), torch.device("cuda"))
    names = np.array(idx.class_names)
    true = list(names[src])
    trace_dir = WORK / "trace"
    profiling.reset()
    reset_launches()
    t0 = time.time()
    with profiling.trace(trace_dir):
        result = pipelines.run_read_benchmark(model, reads, true, out_dir=WORK / "read_benchmark", device="cuda")
    e2e = time.time() - t0
    launches = read_launches()
    log(f"  read benchmark: kernel launches {launches}")
    require(launches["unpack_2bit"] == launches["reads_query"] > 0 and launches["records_wire"] == 0,
            "the read benchmark did not run K1 once for each K2 launch")
    tie = (counts == counts.max(axis=1)[:, None]).sum(axis=1) > 1
    want = np.where(tie, "ambiguous", names[counts.argmax(axis=1)])
    got = np.array([row[2] for row in result.rows])
    require(np.array_equal(got, want), "a read benchmark prediction differs from the tie rule on the facade's counts")
    stats = result.stats
    log(f"  read benchmark: every prediction is the tie rule's argmax of the facade's counts "
        f"({int(tie.sum())} ambiguous); accuracy {stats['accuracy']:.6f}, macro F1 {stats['macro_f1']:.6f}, "
        f"coverage {stats['coverage']:.6f}, selective accuracy {stats['selective_accuracy']:.6f}")
    busy = trace_busy_share(trace_dir, ("unpack_kernel", "reads_query_kernel"))
    log(f"  trace [{card}] read benchmark, {len(reads)} reads under torch.profiler ({e2e:.2f} s with the "
        f"profiler): window {busy['window_ms']:.3f} ms, kernels busy {busy['kernel_busy_ms']:.3f} ms, "
        f"device busy share {busy['busy_share']:.6f} (idle {1 - busy['busy_share']:.6f}); copies "
        f"{busy['memcpy_ms']:.3f} ms; {busy['kernel_events']} kernel events, K1 {busy['found']['unpack_kernel']}, "
        f"K2 {busy['found']['reads_query_kernel']}")
    log(f"  phases [{card}] read benchmark: {json.dumps(profiling.report())}")
    return launches, busy


# ---------------------------------------------------------------- phase 5


def check_svm(idx, genomes, rng):
    """An SVM species model over the reads path: scores.csv written here,
    the head fitted by the port's libsvm solver on the CPU as well, one
    FASTQ of a single class classified on the card."""
    from xspect2_tpu_torch import classify
    from xspect2_tpu_torch.definitions import get_xspect_model_path
    from xspect2_tpu_torch.models.svm_head import fit_ovo_svc
    from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel

    model = ProbabilisticFilterSVMModel(
        K, "SmokeSvm", None, None, "Species", get_xspect_model_path(), kernel="rbf", c=1.0,
        device="cpu",
    )
    model.index = idx
    model.display_names = {name: f"SmokeSvm {name}" for name in idx.class_names}
    model.save()
    names = sorted(idx.class_names)
    rows = ["file," + ",".join(names) + ",label_id"]
    for j, label in enumerate(names):
        for r in range(5):
            score = np.clip(rng.normal(0.05, 0.02, len(names)), 0, 1)
            score[j] = rng.uniform(0.4, 0.6)
            rows.append(f"acc{j}_{r}," + ",".join(f"{v:.2f}" for v in score) + f",{label}")
    (get_xspect_model_path() / model.slug() / "scores.csv").write_text("\n".join(rows), encoding="utf-8")

    target = 3
    one = genomes[target : target + 1]
    reads, _ = simulate_reads(one, 20_000, rng)
    fastq = WORK / "svm.fastq"
    write_fastq(fastq, reads)
    out = WORK / "svm.json"
    classify.classify_species("SmokeSvm", fastq, out, device="cuda")
    res = json.loads(out.read_text(encoding="utf-8"))
    x = [list(dict(sorted(res["scores"]["total"].items())).values())]
    x_train = [[float(v) for v in row.split(",")[1:-1]] for row in rows[1:]]
    y_train = [row.split(",")[-1] for row in rows[1:]]
    want = str(fit_ovo_svc(x_train, y_train, "rbf", 1.0).predict(x)[0])
    log(f"  svm: prediction {res['prediction']!r}, CPU head {want!r}, source {idx.class_names[target]!r}")
    require(res["prediction"] == want == idx.class_names[target], "svm: wrong prediction")


# ---------------------------------------------------------------- phases 6-7


ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def write_fasta(path: Path, records) -> int:
    """``(id, codes)`` records as FASTA, 80 bases a line; returns the bases written."""
    parts, total = [], 0
    for rid, codes in records:
        seq = ASCII[np.minimum(codes, 4)]
        n = len(seq)
        rows = -(-n // 80)
        lines = np.full(rows * 81, ord("\n"), dtype=np.uint8)
        at = np.arange(n)
        lines[at + at // 80] = seq
        parts += [f">{rid}\n".encode(), lines[: n + rows].tobytes()]
        total += n
    path.write_bytes(b"".join(parts))
    return total


def simulate_assembly(genome, rng, name, n_contigs, subst=0.01, gaps=3):
    """A draft assembly of ``genome``: ``n_contigs`` contigs (> 200 bp,
    long-tailed lengths) cut end to end, ``subst`` of the bases
    substituted, half the contigs reverse-complemented, ``gaps`` 100-N
    scaffold gaps.  Returns ``[(id, codes)]``."""
    g = genome.copy()
    if subst:
        pos = rng.choice(len(g), int(subst * len(g)), replace=False)
        g[pos] = (g[pos] + rng.integers(1, 4, size=len(pos))) % 4
    weights = rng.pareto(1.1, n_contigs) + 0.02
    spare = len(g) - 201 * n_contigs
    lengths = 201 + np.floor(weights / weights.sum() * spare).astype(np.int64)
    lengths[np.argmax(lengths)] += len(g) - lengths.sum()
    ends = np.cumsum(lengths)
    contigs = []
    for i, (e, n) in enumerate(zip(ends, lengths)):
        c = g[e - n : e].astype(np.uint8)
        if i % 2:
            c = (3 - c[::-1]).astype(np.uint8)
        contigs.append([f"{name}_c{i:03d}", c])
    for i in rng.choice(np.nonzero(lengths > 1000)[0], min(gaps, int((lengths > 1000).sum())), replace=False):
        c = contigs[i][1].copy()
        at = int(rng.integers(200, len(c) - 300))
        c[at : at + 100] = 255
        contigs[i][1] = c
    return [tuple(c) for c in contigs]


def restore_err(got, want) -> int:
    """Max |err| between two (codes, record ids, validity) triples."""
    return max(int((g.int() - w.int()).abs().max()) if g.numel() else 0 for g, w in zip(got, want))


def check_restore(wire, n_pos, k, step, rng):
    """K4 on a compact records wire against its plain version: in one
    launch on the ascending patch list of packed_wire_for_batch, shuffled
    (the patch-only launch after it), with no list and with sentinels
    only, and without codes (``records_wire``).  Returns the max |err| and
    the restored triple."""
    from xspect2_tpu_torch.ops import query

    packed, bad_pos, offsets = wire
    args = dict(k=k, step=step)
    got = query.restore_records_wire(packed, bad_pos, offsets, n_pos, **args)
    err = restore_err(got, query.restore_records_wire_plain(packed, bad_pos, offsets, n_pos, **args))
    perm = torch.from_numpy(rng.permutation(bad_pos.numel())).to(bad_pos.device)
    sentinels = query.upload_patch_list(np.full(8, n_pos + k - 1, dtype=np.int32), bad_pos.device)
    for patches in (bad_pos[perm], bad_pos[:0], sentinels):
        err = max(err, restore_err(
            query.restore_records_wire(packed, patches, offsets, n_pos, **args),
            query.restore_records_wire_plain(packed, patches, offsets, n_pos, **args)))
    err = max(err, restore_err(query.records_wire(offsets, n_pos, **args), got[1:]))
    return err, got


def check_records_kernels(rng, errors):
    """K3 and K4 equal their plain versions on the card, exactly, on both
    wires, at the four index layouts and steps 1 and 3."""
    from xspect2_tpu_torch.ops import query

    dev = torch.device("cuda")
    cases = [(1, 3, 1), (1, 3, 3), (8, 2, 1), (8, 4, 3), (40, 7, 1), (40, 7, 3), (512, 3, 1), (512, 3, 3)]
    for num_classes, h, step in cases:
        idx = random_index(num_classes, h, rng)
        engine = query.DeviceQueryEngine(idx, device=dev)
        genome = rng.integers(0, 4, size=300_000, dtype=np.uint8)
        records = []
        for i in range(600):
            n = int(K + 1 + rng.pareto(1.0) * 60) if i % 7 else 5000
            n = min(n, 20_000)
            s = int(rng.integers(0, len(genome) - n))
            c = genome[s : s + n].copy()
            if i % 5 == 0:
                c[rng.integers(0, n, 2)] = 255
            records.append((f"r{i}", c))
        batch = query.prepare_batch(records, K, step=step, chunk=engine.chunk)
        max_records = query._next_pow2(max(8, batch.num_records))
        wire = engine.upload_records_wire(batch, max_records)
        err4, (codes, rec, valid) = check_restore(wire, batch.num_positions, K, step, rng)
        require(bool((valid.cpu().numpy() == batch.valid).all()), "records_wire: validity differs from the batch")
        errors["records_wire"] = max(errors["records_wire"], err4)
        geom = dict(max_records=max_records, **engine.geometry())
        shortest = int(np.diff(batch.offsets).min())
        raw = [torch.from_numpy(a).to(dev) for a in (batch.codes, batch.rec_ids, batch.valid)]
        err3 = 0
        for inputs, hint in (((codes, rec, valid), shortest), (raw, shortest), (raw, 10**6)):
            got = query.records_query(*inputs, engine.table, min_record_len=hint, **geom)
            want = query.records_query_plain(*inputs, engine.table, **geom)
            err3 = max(err3, int((got.long() - want.long()).abs().max()))
        errors["records_query"] = max(errors["records_query"], err3)
        log(
            f"  records kernels vs plain: C={num_classes} P={idx.fields_per_word} h={h} "
            f"step={step}, {batch.num_records} records, {batch.num_positions} positions: "
            f"max |err| K4 {err4}, K3 {err3}, hits {int(got.sum())}"
        )
    require(errors["records_wire"] == 0, "records_wire disagrees with its plain version")
    require(errors["records_query"] == 0, "records_query disagrees with its plain version")
    # drawn from a child of rng, so the later phases draw what they drew
    check_padded_restore(rng.spawn(1)[0], errors)


def check_padded_restore(rng, errors):
    """K4 at many short records with max_records padded by empty records:
    55,925 reads of 150 bp in 65,536 record slots (the first batch of a
    validated run), and 64 records of 256 bp in 128 slots whose last base
    ends a 4,096-position tile; exact against its plain version."""
    from xspect2_tpu_torch.ops import query

    dev = torch.device("cuda")
    genome = rng.integers(0, 4, size=1_000_000, dtype=np.uint8)
    for n_real, read_len, max_records, chunk in ((55_925, 150, 65_536, query.DEFAULT_CHUNK),
                                                 (64, 256, 128, 4096)):
        starts = rng.integers(0, len(genome) - read_len, size=n_real)
        records = [(f"r{i}", genome[at : at + read_len].copy()) for i, at in enumerate(starts)]
        for i in range(0, n_real, 97):
            records[i][1][int(rng.integers(0, read_len))] = 255
        batch = query.prepare_batch(records, K, step=1, chunk=chunk)
        real = int(batch.offsets[-1])
        err, (_, rec, _) = check_restore(query.upload_records_wire(batch, max_records, dev),
                                         batch.num_positions, K, 1, rng)
        past = bool((rec[real:] == max_records - 1).all())
        errors["records_wire"] = max(errors["records_wire"], err)
        log(f"  records_wire vs plain: {n_real} records of {read_len} bp in {max_records} slots, "
            f"{batch.num_positions} positions (the last real base ends a tile: {real % 4096 == 0}), "
            f"max |err| {err}")
        require(err == 0 and past, "records_wire disagrees with its plain version past empty records")


def host_record_counts(idx, codes, step, k=K):
    from xspect2_tpu_torch.core import dna

    return idx.count_hits_host(*dna.canonical_kmers(codes, k, step=step))


def check_assembly_result(res, contigs, idx, step, rng, label, exact_hits=False):
    """num_kmers of every contig, and a sample's counts against the host."""
    names = idx.class_names
    require(list(res["hits"]) == [cid for cid, _ in contigs], f"{label}: contigs differ")
    for cid, c in contigs:
        require(res["num_kmers"][cid] == -(-(len(c) - K + 1) // step), f"{label}: num_kmers of {cid}")
    small = [i for i, (_, c) in enumerate(contigs) if len(c) <= 100_000]
    gapped = [i for i, (_, c) in enumerate(contigs) if (c > 3).any() and len(c) <= 300_000]
    sample = set(rng.choice(small, min(3, len(small)), replace=False).tolist()) | set(gapped[:1])
    sample.add(int(np.argmin([len(c) for _, c in contigs])))
    for i in sorted(sample):
        cid, c = contigs[i]
        got = np.array([res["hits"][cid][n] for n in names])
        require(np.array_equal(got, host_record_counts(idx, c, step)), f"{label}: {cid} differs from the host")
    if exact_hits:
        for cid, c in contigs:
            bad = np.concatenate([[0], np.cumsum(c > 3)])
            starts = np.arange(0, len(c) - K + 1, step)
            clean = int(((bad[starts + K] - bad[starts]) == 0).sum())
            require(res["hits"][cid][names[0]] == clean, f"{label}: {cid} missed a window")
    return len(sample)


def records_breakdown(model_cls, slug, path, step, card):
    """Host-clock seconds of each step of one assembly, each ending in a
    sync, on a freshly loaded model whose table and SVM head are made
    first (the facades' model cache keeps both across files)."""
    from xspect2_tpu_torch import native
    from xspect2_tpu_torch.core import dna
    from xspect2_tpu_torch.io.fasta import get_record_iterator
    from xspect2_tpu_torch.model_management import metadata_path
    from xspect2_tpu_torch.ops import query

    model = model_cls.load(metadata_path(slug), device="cuda")
    model.engine  # noqa: B018 - uploads the table before timing
    torch.cuda.synchronize()
    t0 = time.time()
    model._get_svm(None)
    head_s = time.time() - t0
    t0 = time.time()
    native.parse_file(path)
    t1 = time.time()
    recs = list(get_record_iterator(path))
    t2 = time.time()
    batch = query.prepare_batch([(r.id, dna.encode(r.seq)) for r in recs], K, step=step, chunk=model.engine.chunk)
    t3 = time.time()
    query.packed_wire_for_batch(batch, query._next_pow2(max(8, batch.num_records)))
    t4 = time.time()
    model.engine.count_hits(batch)
    t5 = time.time()
    res = model.predict(path, step=step)
    t6 = time.time()
    res.save(WORK / "records-breakdown.json")
    t7 = time.time()
    steps = {
        "route check (native parse)": t1 - t0, "parse": t2 - t1, "encode + prepare_batch": t3 - t2,
        "pack": t4 - t3, "count (pack, copy, kernels, fetch)": t5 - t4,
        # predict repeats every step above but the separate pack
        "hit dicts + scores + SVM": (t6 - t5) - (t5 - t0 - (t4 - t3)), "result JSON": t7 - t6,
    }
    log(f"  breakdown [{card}] {slug} step {step}, one assembly, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
        + f"; SVM head fit once per loaded model {head_s:.3f}")


def records_bound(idx, codes, rec, valid, n_pos, out_bytes):
    """K3's bound on these inputs under the row-major layout: the codes,
    record ids and validity once, each table sector a counted window
    touches once, the output once (bytes); ~WINDOW_OPS + TABLE_OPS + 3
    per probe word a counted window (operations).  Returns a dict of
    both, the no-reuse bytes and the sector counts."""
    from xspect2_tpu_torch.ops import query

    hi, lo, bad = query._canonical_windows_plain(codes[None, : n_pos + K - 1].long(), K, n_pos)
    keep = valid & ~bad[0]
    counted = int(keep.sum())
    seen = table_sectors(idx)
    window_sectors = probe_sectors(idx, hi[0, keep], lo[0, keep], seen)
    run_sectors = int(seen.sum())
    del hi, lo, bad, keep
    probes = idx.num_hashes * (idx.class_words if idx.fields_per_word == 1 else 1)
    in_bytes = codes.numel() + 5 * n_pos
    bytes_ms = (in_bytes + run_sectors * SECTOR_BYTES + out_bytes) / HBM_BYTES_PER_S * 1e3
    no_reuse_ms = bytes_ms + (window_sectors - run_sectors) * SECTOR_BYTES / HBM_BYTES_PER_S * 1e3
    ops_ms = counted * (WINDOW_OPS + TABLE_OPS + 3 * probes) / INT_OPS_PER_S * 1e3
    return dict(bytes_ms=bytes_ms, ops_ms=ops_ms, no_reuse_ms=no_reuse_ms, counted=counted, probes=probes,
                window_sectors=window_sectors, run_sectors=run_sectors)


def bound_text(b) -> str:
    per = b["window_sectors"] / max(1, b["counted"])
    return (f"bound {max(b['bytes_ms'], b['ops_ms']):.4f} ms (bytes {b['bytes_ms']:.4f} reading each of the "
            f"{b['run_sectors']} table sectors touched once under the row-major layout, operations "
            f"{b['ops_ms']:.4f}); {b['counted']} windows probed x {b['probes']} words, {per:.3f} sectors a "
            f"window, {b['no_reuse_ms']:.4f} ms with no reuse between windows")


def time_records_kernels(engine, batch, card, errors, rng, label):
    """K4 (the records wire restored in one launch) and K3 on one batch
    of the records route (``label`` names it): exact against their plain
    versions; call and device-only time, bound, plain time; K4's
    record-id half against ``torch.searchsorted``."""
    from xspect2_tpu_torch.ops import query

    max_records = query._next_pow2(max(8, batch.num_records))
    wire = engine.upload_records_wire(batch, max_records)
    packed, bad_pos, offsets = wire
    n_tot, n_pos, step = len(batch.codes), batch.num_positions, batch.step
    err4, (codes, rec, valid) = check_restore(wire, n_pos, K, step, rng)
    errors["records_wire"] = max(errors["records_wire"], err4)
    geom = dict(max_records=max_records, **engine.geometry())
    shortest = int(np.diff(batch.offsets).min())
    got = query.records_query(codes, rec, valid, engine.table, min_record_len=shortest, **geom)
    want = query.records_query_plain(codes, rec, valid, engine.table, **geom)
    err3 = int((got.long() - want.long()).abs().max())
    errors["records_query"] = max(errors["records_query"], err3)
    del want
    log(f"  records kernels vs plain ({label}): max |err| K4 {err4}, K3 {err3}")
    require(err4 == 0 and err3 == 0, f"a records kernel disagrees with its plain version ({label})")

    def restore():
        return query.restore_records_wire(packed, bad_pos, offsets, n_pos, k=K, step=step)

    k4 = timed(restore, 20)
    k4_plain = cuda_ms(lambda: query.restore_records_wire_plain(packed, bad_pos, offsets, n_pos, k=K, step=step), 3)
    k4_ids = timed(lambda: query.records_wire(offsets, n_pos, k=K, step=step), 20)
    pos = torch.arange(n_pos, dtype=torch.int32, device=codes.device)
    bounds = offsets[1:]
    require(torch.equal(torch.searchsorted(bounds, pos, right=True, out_int32=True).clamp_(max=max_records - 1), rec),
            "torch.searchsorted differs from K4's record ids")
    library = timed(lambda: torch.searchsorted(bounds, pos, right=True, out_int32=True), 20)
    k3 = timed(lambda: query.records_query(codes, rec, valid, engine.table, min_record_len=shortest, **geom), 10)
    k3_plain = cuda_ms(lambda: query.records_query_plain(codes, rec, valid, engine.table, **geom), 1)
    shape = f"{label}: {batch.num_records} records, {n_pos} positions, step {step}"

    k4_bytes = packed.numel() + 4 * bad_pos.numel() + 4 * offsets.numel() + n_tot + 5 * n_pos
    b3 = records_bound(engine.index, codes, rec, valid, n_pos, got.numel() * 4)
    k3_bytes_ms, k3_ops_ms = b3["bytes_ms"], b3["ops_ms"]
    out = {
        "records_wire": dict(
            k4, plain_ms=k4_plain, bound_ms=k4_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=library["ms"], library_device_ms=library["device_ms"], library_device_by=library["device_by"],
            library_computes="record ids only: torch.searchsorted(offsets[1:], pos, right=True, out_int32=True)",
            ids_only=k4_ids,
        ),
        "records_query": dict(
            k3, plain_ms=k3_plain, bound_ms=max(k3_bytes_ms, k3_ops_ms),
            bound_by="bytes" if k3_bytes_ms >= k3_ops_ms else "operations",
        ),
    }
    for name, t in out.items():
        log(f"  timing [{card}] {name} ({shape}): {ms_text(t)}, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms")
    log(f"  timing [{card}] records_wire without codes ({shape}): {ms_text(k4_ids)}; torch.searchsorted "
        f"(record ids only): {ms_text(library)}")
    log(f"  records_query: {bound_text(b3)}")
    real = int(batch.offsets[-1])
    log(f"  device-side [{card}] ({label}): {real / ((k4['ms'] + k3['ms']) / 1e3) / 1e6:.1f} M bases/s "
        f"({real} bases; wire + query kernels, call times)")
    return out



def check_short_restore(engine, rng, errors):
    """K4 on the flat wire of 65,536 short records (22-119 bp, step 2),
    exact against its plain version."""
    from xspect2_tpu_torch.ops import query

    genome = rng.integers(0, 4, size=1_000_000, dtype=np.uint8)
    short = []
    for i in range(65_536):
        n = int(rng.integers(K + 1, 120))
        at = int(rng.integers(0, len(genome) - n))
        c = genome[at : at + n].copy()
        if i % 9 == 0:
            c[rng.integers(0, n)] = 255
        short.append((f"s{i}", c))
    sb = query.prepare_batch(short, K, step=2, chunk=engine.chunk)
    s_err, _ = check_restore(query.upload_records_wire(sb, query._next_pow2(sb.num_records), engine.device),
                             sb.num_positions, K, 2, rng)
    errors["records_wire"] = max(errors["records_wire"], s_err)
    log(f"  records_wire vs plain: 65,536 short records ({sb.num_positions} positions, step 2), max |err| {s_err}")
    require(s_err == 0, "records_wire disagrees with its plain version on short records")


def time_wide_records_query(batch, rng, card, errors):
    """K3 at 512 classes (cw=16, h=3, 8 rows a block: a random 514 MB
    table whose words are the AND of two random words, so a random k-mer
    hits a class w.p. 1/64) on one 4 Mbp assembly (``batch``), and on
    ~4 M positions of 30-120 bp records with the shortest record as the
    hint (the shared-counter path) and with a hint of 10**6 (blocks whose
    record span exceeds their 16 counter rows count with global atomics):
    exact against the plain version; time, bound, plain time."""
    from xspect2_tpu_torch.ops import query

    dev = torch.device("cuda")
    idx = random_index(512, 3, rng, num_kmers=500_000)
    idx.table &= rng.integers(0, 2**32, size=idx.table.size, dtype=np.uint64).astype(np.uint32)
    require((idx.class_words, idx.rows_per_block, idx.fields_per_word) == (16, 8, 1),
            "the 512-class geometry is not cw=16, 8 rows, P=1")
    engine = query.DeviceQueryEngine(idx, device=dev)
    genome = rng.integers(0, 4, size=1_000_000, dtype=np.uint8)
    records, total = [], 0
    while total < GENOME_LEN:
        n = int(rng.integers(30, 121))
        at = int(rng.integers(0, len(genome) - n))
        records.append((f"s{len(records)}", genome[at : at + n]))
        total += n
    short = query.prepare_batch(records, K, chunk=engine.chunk)
    cases = (("one 4 Mbp assembly", batch, None), ("short records, shared counters", short, None),
             ("short records, global atomics", short, 10**6))
    out = {}
    for label, b, hint in cases:
        max_records = query._next_pow2(max(8, b.num_records))
        n_pos = b.num_positions
        codes, rec, valid = query.restore_records_wire(
            *engine.upload_records_wire(b, max_records), n_pos, k=K, step=b.step)
        hint = hint or int(np.diff(b.offsets).min())
        geom = dict(max_records=max_records, **engine.geometry())
        got = query.records_query(codes, rec, valid, engine.table, min_record_len=hint, **geom)
        want = query.records_query_plain(codes, rec, valid, engine.table, **geom)
        err = int((got - want).abs().max())
        errors["records_query"] = max(errors["records_query"], err)
        require(err == 0, f"records_query disagrees with its plain version at 512 classes ({label})")
        del want
        ms = cuda_ms(lambda: query.records_query(codes, rec, valid, engine.table, min_record_len=hint, **geom), 10)
        plain_ms = cuda_ms(lambda: query.records_query_plain(codes, rec, valid, engine.table, **geom), 1, warm=False)
        # the blocks whose record span exceeds their counter rows: the global-atomic path
        ppb, rows = query._block_range(idx.num_classes, max_records, hint, K)
        nb = -(-n_pos // ppb)
        ok = torch.nn.functional.pad(valid & (rec >= 0) & (rec < max_records), (0, nb * ppb - n_pos)).view(nb, ppb)
        r = torch.nn.functional.pad(rec, (0, nb * ppb - n_pos)).view(nb, ppb)
        first = torch.where(ok, r, torch.iinfo(torch.int32).max).min(dim=1).values
        last = torch.where(ok, r, -1).max(dim=1).values
        used = last >= 0
        wide = int(((last - first + 1 > rows) & used).sum())
        b3 = records_bound(idx, codes, rec, valid, n_pos, got.numel() * 4)
        log(f"  timing [{card}] records_query, 512 classes ({label}: {b.num_records} records, {n_pos} positions, "
            f"hint {hint}; {wide} of {int(used.sum())} thread blocks count with global atomics): {ms:.4f} ms, "
            f"{bound_text(b3)}; plain {plain_ms:.4f} ms; max |err| {err}, hits {int(got.sum())}")
        out[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(b3["bytes_ms"], b3["ops_ms"]),
                          global_blocks=wide, blocks=int(used.sum()))
        del codes, rec, valid, got
    require(out["short records, global atomics"]["global_blocks"] > 0
            and out["short records, shared counters"]["global_blocks"] == 0,
            "the short-record cases do not take the shared and the global-atomic path")
    return out


def train_records_models(base, names, card):
    """``train_from_directory(meta=True)`` on the ``cobs/`` + ``svm/`` tree
    at ``base``: the 40-class SVM species model and the genus model over
    the metagenome of all classes.  Returns the kernel launches and the
    seconds of the call."""
    from xspect2_tpu_torch import train
    from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel
    from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel

    seconds: dict = {}
    reset_launches()
    t0 = time.time()
    with stopwatch(train, "concatenate_species_fasta_files", seconds, "species concatenation"), \
            stopwatch(ProbabilisticFilterSVMModel, "fit", seconds, "species fit (index + SVM scores)"), \
            stopwatch(train, "concatenate_metagenome", seconds, "metagenome concatenation"), \
            stopwatch(ProbabilisticSingleFilterModel, "fit", seconds, "genus fit"):
        train.train_from_directory("SmokeAsm", base, meta=True,
                                   translation_dict={n: f"SmokeAsm {n}" for n in names}, device="cuda")
    total = time.time() - t0
    launches = read_launches()
    log(f"  train_from_directory [{card}]: {total:.2f} s; " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
        + f", the rest (staging, saves) {total - sum(seconds.values()):.2f}; launches {launches}")
    require(launches["records_wire"] == launches["records_query"] > 0 and launches["unpack_2bit"] == 0,
            "the SVM scoring of fit did not launch K4 once per batch (one K3 each), or K1")
    return launches, total


def check_metagenome_genus(genomes, names, rng, card):
    """classify_genus with the genus model that ``meta=True`` trained, on
    assemblies of two class genomes (contigs of the metagenome): every
    N-free window hits, sampled contigs equal the host reference."""
    from xspect2_tpu_torch import classify
    from xspect2_tpu_torch.model_management import get_genus_model_path
    from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel

    genus = ProbabilisticSingleFilterModel.load(get_genus_model_path("SmokeAsm"), device="cuda")
    idx = genus.index
    log(f"  genus model over the metagenome: C={idx.num_classes} h={idx.num_hashes} P={idx.fields_per_word}, "
        f"{idx.num_blocks} blocks, {idx.nbytes / 1e6:.1f} MB, class {idx.class_names}")
    in_dir = WORK / "metagenome_assemblies"
    in_dir.mkdir()
    assemblies = []
    for a, ci in enumerate(rng.choice(len(names), META_ASSEMBLIES, replace=False)):
        contigs = simulate_assembly(genomes[ci], rng, f"m{a}", int(rng.integers(20, 401)), subst=0)
        write_fasta(in_dir / f"masm{a}.fasta", contigs)
        assemblies.append(contigs)
    out = WORK / "metagenome_asm" / "res.json"
    reset_launches()
    t0 = time.time()
    classify.classify_genus("SmokeAsm", in_dir, out, device="cuda")
    e2e = time.time() - t0
    launches = read_launches()
    require(launches["records_wire"] == launches["records_query"] > 0 and launches["unpack_2bit"] == 0,
            "metagenome assemblies: K4 was not launched once per batch (one K3 each), or K1 was launched")
    checked = 0
    for a, contigs in enumerate(assemblies):
        res = json.loads((out.parent / f"res_{a + 1}.json").read_text(encoding="utf-8"))
        checked += check_assembly_result(res, contigs, idx, 1, rng, f"masm{a}", exact_hits=True)
    log(f"  end-to-end [{card}] metagenome genus assemblies: {META_ASSEMBLIES} in {e2e:.2f} s; every N-free window "
        f"of every contig hit, {checked} sampled contigs equal the host reference; launches {launches}")
    return launches


def run_records(rng, card, errors):
    """Train the 40-class SVM species model and the metagenome genus model
    through ``train_from_directory``, classify held-out assemblies."""
    from xspect2_tpu_torch import classify
    from xspect2_tpu_torch.definitions import get_xspect_model_path
    from xspect2_tpu_torch.model_management import metadata_path
    from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel
    from xspect2_tpu_torch.ops import query

    base = WORK / "records"
    names = [f"{100 + i}" for i in range(ASM_CLASSES)]
    genomes = rng.integers(0, 4, size=(ASM_CLASSES, GENOME_LEN), dtype=np.uint8)
    # draws the phase adds come from a child generator, so later phases draw what they drew
    child = rng.spawn(1)[0]
    t0 = time.time()
    for name, g in zip(names, genomes):
        (base / "cobs" / name).mkdir(parents=True)
        write_fasta(base / "cobs" / name / f"{name}.fasta", [(f"{name}_genome", g)])
        (base / "svm" / name).mkdir(parents=True)
        for j in range(2):
            s = int(rng.integers(0, GENOME_LEN - SVM_LEN))
            stretch = genomes[int(name) - 100][s : s + SVM_LEN]
            contigs = simulate_assembly(stretch, rng, f"{name}s{j}", int(rng.integers(5, 100)), gaps=1)
            write_fasta(base / "svm" / name / f"GCF_{name}{j}.fasta", contigs)
    log(f"  wrote {ASM_CLASSES} class genomes and {2 * ASM_CLASSES} SVM assemblies in {time.time() - t0:.1f} s")

    fit_launches, fit_s = train_records_models(base, names, card)
    model = ProbabilisticFilterSVMModel.load(metadata_path("SmokeAsm-species"), device="cuda")
    idx = model.index
    log(f"  fit [{card}]: C={idx.num_classes} h={idx.num_hashes} P={idx.fields_per_word} "
        f"cw={idx.class_words}, {idx.num_blocks} blocks, {idx.nbytes / 1e6:.1f} MB, "
        f"{2 * ASM_CLASSES} SVM assemblies scored, {fit_s:.2f} s with the genus model")
    require((idx.num_hashes, idx.fields_per_word, idx.class_words) == (7, 1, 2),
            "the 40-class geometry is not h=7, P=1, cw=2")
    scores = (get_xspect_model_path() / model.slug() / "scores.csv").read_text(encoding="utf-8").splitlines()
    require(len(scores) == 1 + 2 * ASM_CLASSES, "scores.csv has the wrong row count")
    own = [float(row.split(",")[1 + names.index(row.split(",")[-1])]) for row in scores[1:]]
    log(f"  scores.csv: own-class score {min(own):.2f}-{max(own):.2f}")

    asm_reads, _ = simulate_reads(genomes, NUM_READS, rng)
    held = rng.choice(ASM_CLASSES, HELD_OUT, replace=False)
    in_dir = base / "held_out"
    in_dir.mkdir()
    assemblies, total_bases = [], 0
    for a, ci in enumerate(held):
        contigs = simulate_assembly(genomes[ci], rng, f"a{a:02d}", int(rng.integers(20, 401)))
        total_bases += write_fasta(in_dir / f"asm{a:02d}.fasta", contigs)
        assemblies.append((names[ci], contigs))
    launches = {name: 0 for name in KERNELS}
    add_launches(launches, fit_launches)
    add_launches(launches, check_metagenome_genus(genomes, names, child, card))
    # validation: the first three classes, held for phase 6d
    val_genomes = {names[i]: genomes[i].copy() for i in range(3)}
    del genomes

    for step in (1, 4):
        out = base / f"species_step{step}" / "res.json"
        reset_launches()
        t0 = time.time()
        classify.classify_species("SmokeAsm", in_dir, out, step=step, device="cuda")
        e2e = time.time() - t0
        got = read_launches()
        log(f"  records step {step}: kernel launches {got}")
        require(got["records_wire"] == got["records_query"] > 0 and got["unpack_2bit"] == 0,
                "the records path did not launch K4 once per batch (one K3 each) and K1 never")
        require(got["reads_query"] == 0, "the records path launched reads_query")
        require(got["svm_head"] == HELD_OUT, "the species model did not launch K11 once an assembly")
        for name, v in got.items():
            launches[name] += v
        log(f"  end-to-end [{card}] species assemblies, step {step}: {HELD_OUT} assemblies "
            f"({total_bases} bases) in {e2e:.2f} s, {HELD_OUT / e2e:.2f} assemblies/s, "
            f"{total_bases / e2e / 1e6:.2f} M bases/s")
        checked = 0
        for a, (label, contigs) in enumerate(assemblies):
            res = json.loads((out.parent / f"res_{a + 1}.json").read_text(encoding="utf-8"))
            require(res["prediction"] == label, f"asm{a:02d} step {step}: predicted {res['prediction']}, source {label}")
            checked += check_assembly_result(res, contigs, idx, step, rng, f"asm{a:02d} step {step}")
        log(f"  records step {step}: all {HELD_OUT} SVM predictions are the source class; "
            f"{checked} sampled contigs equal the host reference; num_kmers of every contig right")
        records_breakdown(ProbabilisticFilterSVMModel, "SmokeAsm-species", in_dir / "asm00.fasta", step, card)

    add_launches(launches, run_assembly_benchmark(in_dir, assemblies, base / "species_step1", card))
    add_launches(launches, run_surfaces(in_dir / "asm00.fasta", base / "species_step1" / "res_1.json", card))

    model = ProbabilisticFilterSVMModel.load(metadata_path("SmokeAsm-species"), device="cuda")
    batch = query.prepare_batch(assemblies[0][1], K, step=1, chunk=model.engine.chunk)
    timings = time_records_kernels(model.engine, batch, card, errors, rng, "one 4 Mbp assembly")
    check_short_restore(model.engine, rng, errors)
    timings["records_query"]["classes_512"] = time_wide_records_query(batch, rng, card, errors)
    label, contigs = assemblies[0]
    single = json.loads((base / "species_step1" / "res_1.json").read_text(encoding="utf-8"))
    return launches, timings, dict(model=model, reads=asm_reads, contigs=contigs, label=label, single=single,
                                   val_genomes=val_genomes, child=child)


def run_assembly_benchmark(in_dir, assemblies, facade_dir, card):
    """``pipelines.run_assembly_benchmark`` on the 40-class model and the
    held-out assemblies at step 1 (K4 + K3 through ``model.predict``):
    its predictions are the ``classify_species`` predictions of the same
    files; prints its F1 statistics."""
    from xspect2_tpu_torch import pipelines
    from xspect2_tpu_torch.model_cache import load_cached
    from xspect2_tpu_torch.model_management import metadata_path
    from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel

    model = load_cached(ProbabilisticFilterSVMModel, metadata_path("SmokeAsm-species"), torch.device("cuda"))
    samples = [(in_dir / f"asm{a:02d}.fasta", label) for a, (label, _) in enumerate(assemblies)]
    reset_launches()
    t0 = time.time()
    result = pipelines.run_assembly_benchmark(model, samples, step=1, out_dir=WORK / "assembly_benchmark",
                                              device="cuda")
    e2e = time.time() - t0
    launches = read_launches()
    require(launches["records_wire"] == launches["records_query"] > 0 and launches["reads_query"] == 0,
            "the assembly benchmark did not take the records route (K4 + K3 a batch)")
    facade = [json.loads((facade_dir / f"res_{a + 1}.json").read_text(encoding="utf-8"))["prediction"]
              for a in range(len(samples))]
    require([row[2] for row in result.rows] == facade,
            "an assembly benchmark prediction differs from classify_species'")
    log(f"  assembly benchmark [{card}]: {len(samples)} assemblies in {e2e:.2f} s, launches {launches}; "
        f"every prediction is classify_species'; stats {json.dumps(result.stats)}")
    return launches


def run_surfaces(asm_path, facade_json, card):
    """The CLI (a subprocess, no ``--device``: the card) and the web app
    (werkzeug's test client: upload, classify, join, result) classify one
    held-out assembly on the 40-class model; both results must equal the
    facade's JSON.  The CLI needs click and the app werkzeug; cheroot
    serves the app (``web.serve``) and is not driven here.  Which of them
    is missing on this machine is decided before anything runs and
    printed, and a surface whose package is missing is not run."""
    import importlib.util

    missing = [m for m in ("click", "werkzeug", "cheroot") if importlib.util.find_spec(m) is None]
    launches = {name: 0 for name in KERNELS}
    if missing:
        log(f"  surfaces: missing on this machine: {', '.join(missing)}"
            + ("; the CLI is not run" if "click" in missing else "")
            + ("; the web app is not run" if "werkzeug" in missing else "")
            + ("; web.serve (cheroot) cannot serve here" if "cheroot" in missing else ""))
    if "click" in missing and "werkzeug" in missing:
        return launches
    want = json.loads(facade_json.read_text(encoding="utf-8"))
    out = WORK / "surfaces"
    out.mkdir()
    if "click" not in missing:
        run_cli(asm_path, out, want, card)
    if "werkzeug" not in missing:
        launches = run_web_app(asm_path, want, card)
    return launches


def run_cli(asm_path, out, want, card):
    """``python -m xspect2_tpu_torch.main classify species`` in its own
    process, with no ``--device`` (the default: the card)."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "xspect2_tpu_torch.main", "classify", "species", "-g", "SmokeAsm",
         "-i", str(asm_path), "-o", str(out / "cli.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=False)
    cli_s = time.time() - t0
    require(proc.returncode == 0, f"the CLI failed ({proc.returncode}): {proc.stderr[-2000:]}")
    require(json.loads((out / "cli.json").read_text(encoding="utf-8")) == want,
            "the CLI's result differs from the facade's")
    log(f"  surfaces [{card}]: CLI classify species (its own process, default --device cuda) in {cli_s:.2f} s "
        f"equals the facade's JSON")


def run_web_app(asm_path, want, card):
    """The web app through werkzeug's test client: upload, classify, the
    task joined, the result fetched."""
    from werkzeug.test import Client

    from xspect2_tpu_torch.web import XspectWebApp

    app = XspectWebApp()
    client = Client(app)
    reset_launches()
    t0 = time.time()
    with open(asm_path, "rb") as f:
        up = client.post("/api/upload-file", data={"file": (f, asm_path.name)})
    require(up.status_code == 200, f"web upload: {up.status_code} {up.data[:200]!r}")
    started = client.post(f"/api/classify?classification_type=Species&model=SmokeAsm&file={asm_path.name}")
    require(started.status_code == 200, f"web classify: {started.status_code} {started.data[:200]!r}")
    app.tasks.join_all(600)
    res = client.get(f"/api/classification-result?uuid={started.get_json()['uuid']}")
    web_s = time.time() - t0
    launches = read_launches()
    require(res.status_code == 200 and res.get_json() == want, "the web app's result differs from the facade's")
    require(launches["records_wire"] == launches["records_query"] > 0, "the web app's task did not run K4 + K3")
    log(f"  surfaces [{card}]: web app upload + classify + result in {web_s:.2f} s (launches {launches}) "
        f"equals the facade's JSON")
    return launches


def run_genus_assemblies(genus_genome, genus_idx, rng, card):
    """classify_genus over assemblies drawn from the genus genome (P=32)."""
    from xspect2_tpu_torch import classify

    in_dir = WORK / "genus_assemblies"
    in_dir.mkdir()
    assemblies, total_bases = [], 0
    for a in range(GENUS_ASSEMBLIES):
        s = int(rng.integers(0, genus_genome.shape[1] - GENOME_LEN))
        contigs = simulate_assembly(genus_genome[0, s : s + GENOME_LEN], rng, f"g{a}", int(rng.integers(20, 401)), subst=0)
        total_bases += write_fasta(in_dir / f"gasm{a}.fasta", contigs)
        assemblies.append(contigs)
    out = WORK / "genus_asm" / "res.json"
    reset_launches()
    t0 = time.time()
    classify.classify_genus("Smoke", in_dir, out, device="cuda")
    e2e = time.time() - t0
    launches = read_launches()
    log(f"  genus assemblies: kernel launches {launches}")
    require(launches["records_wire"] == launches["records_query"] > 0 and launches["unpack_2bit"] == 0,
            "genus assemblies: K4 was not launched once per batch (one K3 each), or K1 was launched")
    require(launches["reads_query"] == 0, "genus assemblies: the records path launched reads_query")
    for a, contigs in enumerate(assemblies):
        res = json.loads((out.parent / f"res_{a + 1}.json").read_text(encoding="utf-8"))
        check_assembly_result(res, contigs, genus_idx, 1, rng, f"gasm{a}", exact_hits=True)
    log(f"  end-to-end [{card}] genus assemblies: {GENUS_ASSEMBLIES} assemblies ({total_bases} bases) "
        f"in {e2e:.2f} s, {GENUS_ASSEMBLIES / e2e:.2f} assemblies/s, {total_bases / e2e / 1e6:.2f} M bases/s; "
        f"every N-free window of every contig hit, sampled contigs equal the host reference")
    return launches, assemblies


# ---------------------------------------------------------------- phase 6d


def validation_reads(genomes, rng):
    """The validation FASTQ's reads and their groups: VAL_MAJORITY reads
    drawn uniformly from the first class, VAL_CLUSTERED from one
    VAL_WINDOW bp window of the second, VAL_SPREAD from the third spread
    evenly (one read a stratum, jittered within its first quarter), half
    reverse-complemented, shuffled.  Uniform draws would sit at Ripley's
    K = 2r boundary and flip with the seed; the strata keep the third
    group below it."""
    stack = np.stack(list(genomes.values()))
    span = GENOME_LEN - READ_LEN
    window = int(rng.integers(0, GENOME_LEN - VAL_WINDOW))
    stratum = span / VAL_SPREAD
    pos = np.concatenate([
        rng.integers(0, span, VAL_MAJORITY),
        window + rng.integers(0, VAL_WINDOW - READ_LEN, VAL_CLUSTERED),
        (np.arange(VAL_SPREAD) * stratum).astype(np.int64) + rng.integers(0, int(stratum / 4), VAL_SPREAD),
    ])
    group = np.repeat([0, 1, 2], [VAL_MAJORITY, VAL_CLUSTERED, VAL_SPREAD])
    order = rng.permutation(len(pos))
    pos, group = pos[order], group[order]
    reads = stack[group[:, None], pos[:, None] + np.arange(READ_LEN)[None, :]].astype(np.uint8)
    rc = rng.random(len(reads)) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    return reads, group


def run_validation(asm, card, errors):
    """``classify_species(..., validation=True)`` on the 40-class SVM model
    (the records route, K4 + K3, then the mapping post-filter on the
    host) against each class's genome seeded as its reference: the
    clustered group moves under ``misclassified``, the others stay; every
    read's hits equal the reads route's (``validation=False``: K1 + K2)
    and, on a sample, the host reference.  Then K4 and K3 at the first
    batch of the validated reads."""
    import xspect2_tpu_torch.misclassification_detection as mc
    from xspect2_tpu_torch import classify
    from xspect2_tpu_torch.core import dna
    from xspect2_tpu_torch.definitions import get_xspect_misclassification_path
    from xspect2_tpu_torch.io.fasta import get_record_iterator
    from xspect2_tpu_torch.models.result import ModelResult
    from xspect2_tpu_torch.ops import query
    from xspect2_tpu_torch.ops.query import DeviceQueryEngine, prepare_batch

    rng, genomes, model = asm["child"], asm["val_genomes"], asm["model"]
    idx = model.index
    names = list(genomes)
    reads, group = validation_reads(genomes, rng)
    n = len(reads)
    fastq = WORK / "validation.fastq"
    write_fastq(fastq, reads)
    ids = np.array([f"r{i:07d}" for i in range(n)])
    for name, g in genomes.items():
        tax_dir = get_xspect_misclassification_path() / name
        tax_dir.mkdir(parents=True)
        write_fasta(tax_dir / f"{name}.fna", [(f"{name}_genome", g)])
    # a reference that is missing would be fetched from NCBI: a closed local port keeps it on the machine
    os.environ["XSPECT_NCBI_URL"] = "http://127.0.0.1:1"

    seconds: dict = {}
    out = WORK / "validation" / "res.json"
    reset_launches()
    t0 = time.time()
    with stopwatch(DeviceQueryEngine, "count_hits", seconds, "count (pack, copy, kernels, fetch)"), \
            stopwatch(mc, "detect_misclassification", seconds, "mapping (group, map, Ripley's K)"), \
            stopwatch(ModelResult, "save", seconds, "result JSON"):
        classify.classify_species("SmokeAsm", fastq, out, validation=True, device="cuda")
    e2e = time.time() - t0
    launches = read_launches()
    log(f"  validation: kernel launches {launches}")
    require(launches["records_wire"] == launches["records_query"] > 0 and launches["unpack_2bit"] == 0
            and launches["reads_query"] == 0, "validation did not take the records route (K4 + K3 a batch)")
    log(f"  end-to-end [{card}] validation: {n} reads in {e2e:.2f} s, {n / e2e:.0f} validated reads/s; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
        + f", the rest (parse, prepare_batch, hit dicts, SVM) {e2e - sum(seconds.values()):.3f} s")
    res = json.loads(out.read_text(encoding="utf-8"))
    flagged = res["misclassified"] or {}
    require(sorted(flagged) == [names[1]] and set(flagged[names[1]]) == set(ids[group == 1]),
            f"validation flagged {sorted(flagged)} ({[len(v) for v in flagged.values()]} reads), "
            f"not exactly the clustered group of {names[1]}")
    require(set(res["hits"]) == set(ids[group != 1]), "validation did not keep exactly the other groups")
    require(res["prediction"] == names[0], f"validation predicted {res['prediction']}, not {names[0]}")
    log(f"  validation: the {VAL_CLUSTERED} clustered reads of {names[1]} moved under misclassified; the "
        f"{VAL_SPREAD} spread reads of {names[2]} and {VAL_MAJORITY} of {names[0]} stayed; prediction {names[0]}")

    reset_launches()
    t0 = time.time()
    classify.classify_species("SmokeAsm", fastq, WORK / "validation" / "plain.json", device="cuda")
    plain_s = time.time() - t0
    plain_launches = read_launches()
    require(plain_launches["unpack_2bit"] == plain_launches["reads_query"] > 0
            and plain_launches["records_query"] == 0, "validation=False did not take the reads route")
    plain = json.loads((WORK / "validation" / "plain.json").read_text(encoding="utf-8"))
    kept = {**res["hits"], **flagged[names[1]]}
    require(kept == plain["hits"], "a validated read's hits differ from the reads route's")
    sample = np.sort(rng.choice(n, SAMPLE, replace=False))
    want = host_counts(idx, reads[sample])
    got = np.array([[kept[ids[i]][c] for c in idx.class_names] for i in sample])
    require(np.array_equal(got, want), "validated counts differ from the host reference")
    log(f"  validation: every read's hits equal the reads route's ({n / plain_s:.0f} reads/s, launches "
        f"{plain_launches}); {SAMPLE} sampled reads equal the host reference")

    records = get_record_iterator(fastq)
    batch = prepare_batch([(r.id, dna.encode(r.seq)) for r in next(iter(model._iter_record_batches(records)))],
                          K, step=1, chunk=model.engine.chunk)
    timings = time_records_kernels(model.engine, batch, card, errors, rng, "first batch of the validated reads")
    # K4 moves a thread past a run of empty records by a binary search, not
    # one record at a time: the batch with its empty records up to
    # max_records and the same batch with none should take about as long
    n_pos, n_real = batch.num_positions, int(batch.offsets[-1])
    walk, ids = {}, []
    for max_records in (query._next_pow2(max(8, batch.num_records)), batch.num_records):
        offsets = model.engine.upload_records_wire(batch, max_records)[2]
        rec, valid = query.records_wire(offsets, n_pos, k=K, step=1)
        ids.append((rec[:n_real], valid))
        walk[max_records] = timed(lambda: query.records_wire(offsets, n_pos, k=K, step=1), 20)
    require(all(torch.equal(a, b) for a, b in zip(*ids)), "K4 record ids depend on the empty records")
    log(f"  timing [{card}] records_wire without codes, first validation batch, by max_records (empty records "
        f"after the {batch.num_records} real ones): "
        + "; ".join(f"{m} ({m - batch.num_records} empty): {ms_text(t)}" for m, t in walk.items()))
    timings["records_wire"]["ids_only_by_max_records"] = {str(m): t for m, t in walk.items()}
    k4 = timings["records_wire"]
    library = dict(ms=k4["library_ms"], device_ms=k4["library_device_ms"], device_by=k4["library_device_by"])
    log(f"  records_wire at the first validation batch [{card}]: {ms_text(k4)}; torch.searchsorted "
        f"(record ids only): {ms_text(library)}")
    launches = {name: launches[name] + plain_launches[name] for name in KERNELS}
    return launches, timings, dict(e2e_s=e2e, reads_per_s=n / e2e, **seconds)


# ---------------------------------------------------------------- phase 7


def seq_str(codes: np.ndarray) -> str:
    return ASCII[np.minimum(codes, 4)].tobytes().decode("ascii")


def host_mlst_totals(model, seq: str, codes: np.ndarray, rng):
    """The per-locus thresholded totals of one long genome on the host, in
    numpy: per-piece counts of every allele (the probe words of each
    k-mer ANDed, their set bits binned by piece and class), counts > 50
    kept and summed over the pieces.  Three sampled pieces per locus are
    held against ``count_hits_host``."""
    from xspect2_tpu_torch.core import dna, hashing
    from xspect2_tpu_torch.models.mlst_model import CHUNK_SCORE_THRESHOLD

    hi, lo, valid = dna.canonical_kmers(codes, MLST_K)
    starts = np.arange(len(hi))
    totals = []
    for li, idx in enumerate(model.indices):
        require(idx.fields_per_word == 1, "the MLST index is field-packed")
        pieces = model.sequence_splitter(seq, model.avg_locus_bp_size[li])
        stride = len(pieces[0]) - MLST_K + 1
        piece_of = np.minimum(starts // stride, len(pieces) - 1)
        num_classes = idx.num_classes
        table = idx.table.reshape(-1, idx.class_words)
        counts = np.zeros(len(pieces) * num_classes, dtype=np.int64)
        for s0 in range(0, len(hi), 1 << 19):
            sel = valid[s0 : s0 + (1 << 19)]
            block, words, _ = hashing.block_words_fieldbase(
                hi[s0 : s0 + (1 << 19)][sel], lo[s0 : s0 + (1 << 19)][sel],
                idx.num_blocks, idx.rows_per_block, idx.num_hashes, 1,
            )
            rows = block.astype(np.int64)[:, None] * idx.rows_per_block + words.astype(np.int64)
            anded = table[rows[:, 0]]
            for j in range(1, idx.num_hashes):
                anded = anded & table[rows[:, j]]
            km, wd = np.nonzero(anded)
            vals = anded[km, wd]
            pc = piece_of[s0 : s0 + (1 << 19)][sel][km]
            for bit in range(32):
                on = ((vals >> np.uint32(bit)) & np.uint32(1)).astype(bool)
                cls = wd[on] * 32 + bit
                ok = cls < num_classes
                counts += np.bincount(pc[on][ok] * num_classes + cls[ok], minlength=len(counts))
        per_piece = counts.reshape(len(pieces), num_classes)
        for i in rng.choice(len(pieces), 3, replace=False):
            want = idx.count_hits_host(*dna.canonical_kmers(dna.encode(pieces[i]), MLST_K))
            require(np.array_equal(per_piece[i], want), "the host MLST reference differs from count_hits_host")
        totals.append(np.where(per_piece > CHUNK_SCORE_THRESHOLD, per_piece, 0).sum(axis=0))
    return totals


def mlst_group(model, seqs, card, errors):
    """One group of long genomes step by step on the host clock (each
    step ends in a sync), then K5 and K6 at the group's shape: time,
    bound, plain time, and for K6 the PyTorch calls that compute it."""
    from xspect2_tpu_torch.core import dna
    from xspect2_tpu_torch.models.mlst_model import CHUNK_SCORE_THRESHOLD
    from xspect2_tpu_torch.models.result import MlstResult
    from xspect2_tpu_torch.ops import query

    engines = model.engines
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    records, seg = [], []
    for b, s in enumerate(seqs):
        for i, piece in enumerate(model.sequence_splitter(s, model.avg_locus_bp_size[0])):
            records.append((f"g{b}p{i}", dna.encode(piece)))
            seg.append(b)
    batch = query.prepare_batch(records, MLST_K, chunk=engines[0].chunk)
    t1 = time.time()
    max_records = query._next_pow2(max(8, batch.num_records))
    wire = query.packed_wire_for_batch(batch, max_records)
    seg_pad = np.zeros(max_records, dtype=np.int32)
    seg_pad[: len(seg)] = seg
    t2 = time.time()
    (packed, bad_pos, offsets), seg_ids = query.wire_to_device(wire, dev), torch.from_numpy(seg_pad).to(dev)
    torch.cuda.synchronize()
    t3 = time.time()
    n_pos = batch.num_positions
    tables = [e.table for e in engines]
    geoms = [e.geometry() for e in engines]
    hint = int(np.median(np.diff(batch.offsets)))
    codes, rec_ids, valid = query.restore_records_wire(packed, bad_pos, offsets, n_pos, k=MLST_K, step=1)
    counts = query.multi_records_query(tables, geoms, codes, rec_ids, valid, max_records=max_records, min_record_len=hint)
    reduced = query.reduce_record_counts(counts, "thresholded_segment_totals", CHUNK_SCORE_THRESHOLD, seg_ids, len(seqs))
    torch.cuda.synchronize()
    t4 = time.time()
    fetched = model._fetch_counts([(r, len(seqs)) for r in reduced])
    t5 = time.time()
    hits = {f"g{b}": model._assemble_hits(s, [c[b] for c in fetched]) for b, s in enumerate(seqs)}
    t6 = time.time()
    MlstResult(model.model_display_name, 1, hits, "group").save(WORK / "mlst-breakdown.json")
    t7 = time.time()
    steps = {
        "split + encode + prepare_batch": t1 - t0, "pack": t2 - t1, "copy": t3 - t2,
        "K4 + K5 + K6": t4 - t3, "fetch": t5 - t4, "assemble": t6 - t5, "result JSON": t7 - t6,
    }
    shape = (f"{len(seqs)} genomes, {batch.num_records} pieces, max_records {max_records}, "
             f"{n_pos} positions, {len(tables)} tables x {geoms[0]['num_classes']} classes")
    log(f"  breakdown [{card}] MLST, one group ({shape}), s: " + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()))
    require(all(tuple(r.shape) == (len(seqs), g["num_classes"]) for r, g in zip(reduced, geoms)),
            "the reduced counts are not [genomes, C] per locus")

    # K5 and K6 against their plain versions at this shape
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain = query.multi_records_query_plain(tables, geoms, codes, rec_ids, valid, max_records=max_records)
    end.record()
    end.synchronize()
    k5_plain = start.elapsed_time(end)
    errors["multi_records_query"] = max(
        errors["multi_records_query"], *(int((a - b).abs().max()) for a, b in zip(counts, plain)))
    plain_red = query.reduce_record_counts_plain(plain, "thresholded_segment_totals", CHUNK_SCORE_THRESHOLD, seg_ids, len(seqs))
    errors["reduce_record_counts"] = max(
        errors["reduce_record_counts"], *(int((a - b).abs().max()) for a, b in zip(reduced, plain_red)))
    require(errors["multi_records_query"] == 0 and errors["reduce_record_counts"] == 0,
            "a multi-index kernel disagrees with its plain version at the MLST group's shape")
    del plain, plain_red

    def library():
        # the PyTorch calls that compute K6's segment form: where, then index_add_
        for h in counts:
            hz = torch.where(h > CHUNK_SCORE_THRESHOLD, h, 0)
            torch.zeros((len(seqs), h.shape[1]), dtype=torch.int32, device=dev).index_add_(0, seg_ids, hz)

    k5 = timed(lambda: query.multi_records_query(
        tables, geoms, codes, rec_ids, valid, max_records=max_records, min_record_len=hint), 5)
    k6 = timed(lambda: query.reduce_record_counts(
        counts, "thresholded_segment_totals", CHUNK_SCORE_THRESHOLD, seg_ids, len(seqs)), 20)
    k5_ms, k6_ms = k5["ms"], k6["ms"]
    k6_plain = cuda_ms(lambda: query.reduce_record_counts_plain(
        counts, "thresholded_segment_totals", CHUNK_SCORE_THRESHOLD, seg_ids, len(seqs)), 5)
    k6_library = cuda_ms(library, 5)
    k6_totals_library = cuda_ms(lambda: [torch.where(h > CHUNK_SCORE_THRESHOLD, h, 0).sum(0) for h in counts], 5)

    # K5's bound: the inputs once, every table sector its counted windows
    # touch once under the row-major layout, the outputs once
    seen = [table_sectors(e.index) for e in engines]
    window_sectors = [0] * len(engines)
    counted = 0
    for p0 in range(0, n_pos, 1 << 21):
        p1 = min(n_pos, p0 + (1 << 21))
        hi, lo, bad = query._canonical_windows_plain(codes[None, p0 : p1 + MLST_K - 1].long(), MLST_K, p1 - p0)
        keep = valid[p0:p1] & ~bad[0]
        counted += int(keep.sum())
        hi, lo = hi[0, keep], lo[0, keep]
        for l, e in enumerate(engines):
            window_sectors[l] += probe_sectors(e.index, hi, lo, seen[l])
    run_sectors = [int(x.sum()) for x in seen]
    del seen, hi, lo, bad, keep
    probes = [e.index.num_hashes * (e.index.class_words if e.index.fields_per_word == 1 else 1) for e in engines]
    out_bytes = sum(c.numel() * 4 for c in counts)
    k5_bytes = len(batch.codes) + 5 * n_pos + sum(run_sectors) * SECTOR_BYTES + out_bytes
    k5_reuse_free_ms = (k5_bytes + (sum(window_sectors) - sum(run_sectors)) * SECTOR_BYTES) / HBM_BYTES_PER_S * 1e3
    # each window packed and hashed once, its block and probe words per table
    k5_ops = counted * (WINDOW_OPS + sum(TABLE_OPS + 3 * pr for pr in probes))
    k5_bytes_ms = k5_bytes / HBM_BYTES_PER_S * 1e3
    k5_ops_ms = k5_ops / INT_OPS_PER_S * 1e3
    k6_bytes = out_bytes + 4 * max_records + sum(r.numel() * 4 for r in reduced)
    k6_bound = k6_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  timing [{card}] multi_records_query ({shape}): {ms_text(k5)}, bound {max(k5_bytes_ms, k5_ops_ms):.4f} ms "
        f"(bytes {k5_bytes_ms:.4f} reading each of the {sum(run_sectors)} table sectors touched once, "
        f"operations {k5_ops_ms:.4f}), plain {k5_plain:.4f} ms")
    log(f"  multi_records_query: {counted} windows probed x {probes} words per table; {sum(window_sectors)} sectors "
        f"summed over windows and tables ({sum(window_sectors) / counted / len(engines):.3f} per window and table "
        f"under the row-major layout), {sum(run_sectors)} distinct over the run; bytes with no reuse between "
        f"windows {k5_reuse_free_ms:.4f} ms")
    log(f"  timing [{card}] reduce_record_counts, segment totals ({shape}): {ms_text(k6)}, bound {k6_bound:.4f} ms "
        f"(bytes), plain {k6_plain:.4f} ms, PyTorch where + index_add_ per table {k6_library:.4f} ms "
        f"(where + sum per table, the totals form: {k6_totals_library:.4f} ms)")
    real = int(batch.offsets[-1])
    log(f"  device-side [{card}]: {real / (k5_ms + k6_ms) * 1e3 / 1e6:.1f} M bases/s ({real} bases; K5 + K6)")
    return {
        "multi_records_query": dict(
            k5, plain_ms=k5_plain, bound_ms=max(k5_bytes_ms, k5_ops_ms),
            bound_by="bytes" if k5_bytes_ms >= k5_ops_ms else "operations", library_ms=None,
        ),
        "reduce_record_counts": dict(
            k6, plain_ms=k6_plain, bound_ms=k6_bound, bound_by="bytes", library_ms=k6_library,
        ),
    }


def run_mlst(rng, card, errors):
    """Train the 7 x 1,000-allele scheme, type 4 Mbp genomes through
    ``classify_mlst`` and ``predict``, check every call and the counts."""
    from xspect2_tpu_torch import classify, model_cache
    from xspect2_tpu_torch.definitions import get_xspect_model_path
    from xspect2_tpu_torch.io.fasta import SeqRecord
    from xspect2_tpu_torch.model_management import get_mlst_model_path
    from xspect2_tpu_torch.models.mlst_model import ProbabilisticFilterMlstSchemeModel

    # no request may leave this machine: the ST-name lookup of every typed
    # genome fails at its import of requests and yields the offline name
    sys.modules["requests"] = None
    os.environ.pop("XSPECT_MLST_BATCH_GENOMES", None)
    base = WORK / "mlst"
    loci = [f"Oxf_gene{i}" for i in range(MLST_LOCI)]
    alleles = rng.integers(0, 4, size=(MLST_LOCI, MLST_ALLELES, ALLELE_LEN), dtype=np.uint8)
    t0 = time.time()
    for li, locus in enumerate(loci):
        (base / "scheme" / locus).mkdir(parents=True)
        for a in range(MLST_ALLELES):
            (base / "scheme" / locus / f"Allele_ID_{a + 1}.fasta").write_text(
                f">{locus}_{a + 1}\n{seq_str(alleles[li, a])}\n", encoding="utf-8")
    log(f"  wrote {MLST_LOCI * MLST_ALLELES} allele files in {time.time() - t0:.1f} s")
    model = ProbabilisticFilterMlstSchemeModel(
        MLST_K, "Oxford", get_xspect_model_path(), "http://localhost:9/db/pubmlst_smoke_seqdef/schemes/1",
        "smoke", device="cuda",
    )
    t0 = time.time()
    model.fit(base / "scheme")
    model.save()
    idx = model.indices[0]
    log(f"  fit [{card}]: {MLST_LOCI} loci x {MLST_ALLELES} alleles x {ALLELE_LEN} bp, k={MLST_K}, fpr {model.fpr}, "
        f"h={idx.num_hashes}, cw={idx.class_words}, rows per block {idx.rows_per_block}, {idx.num_blocks} blocks, "
        f"tables {sum(i.nbytes for i in model.indices)} bytes ({idx.nbytes / 1e6:.1f} MB each), {time.time() - t0:.2f} s")
    require((idx.num_hashes, idx.class_words, idx.fields_per_word) == (1, 32, 1), "the MLST geometry is not h=1, cw=32, P=1")
    del model

    # 4 Mbp genomes with one known allele per locus and a 100-N gap, and
    # short records (< 10 kb, one allele of locus 0) between them, so that
    # a group is flushed when the split status changes
    genomes, picks = [], []
    for g in range(MLST_GENOMES):
        codes = rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)
        codes[50_000:50_100] = 255
        pick = rng.integers(0, MLST_ALLELES, size=MLST_LOCI)
        for li in range(MLST_LOCI):
            at = 100_000 + li * 500_000 + int(rng.integers(0, 400_000))
            codes[at : at + ALLELE_LEN] = alleles[li, pick[li]]
        genomes.append((f"genome{g}", codes))
        picks.append(pick)
    shorts, short_picks = [], []
    for g in range(MLST_SHORT):
        codes = rng.integers(0, 4, size=900, dtype=np.uint8)
        a = int(rng.integers(0, MLST_ALLELES))
        codes[200 : 200 + ALLELE_LEN] = alleles[0, a]
        shorts.append((f"short{g}", codes))
        short_picks.append(a)
    ordered = genomes[:2] + shorts + genomes[2:]
    groups_at_4 = 2 + -(-(MLST_GENOMES - 2) // 4)
    fasta = base / "genomes.fasta"
    total_bases = write_fasta(fasta, ordered)
    out = base / "mlst.json"

    launches = {name: 0 for name in KERNELS}
    mlst_kernels = ("records_wire", "multi_records_query", "reduce_record_counts")
    reset_launches()
    t0 = time.time()
    classify.classify_mlst(fasta, "smoke", "Oxford", out, limit=False, device="cuda")
    e2e = time.time() - t0
    got = read_launches()
    add_launches(launches, got)
    log(f"  MLST: kernel launches of classify_mlst {got}")
    require(all(got[name] == groups_at_4 for name in mlst_kernels),
            f"classify_mlst did not launch each MLST kernel once per group ({groups_at_4} groups of genomes)")
    require(all(v == 0 for name, v in got.items() if name not in mlst_kernels), "classify_mlst launched another path's kernel")
    log(f"  end-to-end [{card}] classify_mlst (model load and table upload included): {len(ordered)} records "
        f"({total_bases} bases) in {e2e:.2f} s")
    res = json.loads(out.read_text(encoding="utf-8"))
    require(res["Scheme"] == "Oxford" and res["Input_source"] == "genomes.fasta", "MLST: wrong result header")
    require(list(res["Results"]) == [rid for rid, _ in ordered], "MLST: records differ")
    for (rid, _), pick in zip(genomes, picks):
        strain = res["Results"][rid][0]["Strain type"]
        for li, locus in enumerate(loci):
            require(next(iter(strain[locus])) == f"Allele_ID_{pick[li] + 1}", f"MLST: {rid} {locus} is not the embedded allele")
        require(str(strain["ST_Name"]).startswith("N/A (PubMLST lookup failed:"), f"MLST: ST_Name of {rid}: {strain.get('ST_Name')!r}")
    for (rid, _), a in zip(shorts, short_picks):
        strain = res["Results"][rid][0]["Strain type"]
        (name, hits), = strain[loci[0]].items()
        require(name == f"Allele_ID_{a + 1}" and hits >= ALLELE_LEN - MLST_K + 1, f"MLST: {rid} misses its allele")
        require(str(strain["ST_Name"]).startswith("N/A (PubMLST lookup failed:"), f"MLST: ST_Name of {rid}")
    log(f"  MLST: every locus of all {MLST_GENOMES} genomes calls its embedded allele; the {MLST_SHORT} short records "
        f"call theirs with at least {ALLELE_LEN - MLST_K + 1} hits; ST_Name is the offline string: "
        f"{res['Results']['genome0'][0]['Strain type']['ST_Name']!r}")

    model = model_cache.load_cached(
        ProbabilisticFilterMlstSchemeModel, get_mlst_model_path("smoke", "Oxford"), torch.device("cuda"))
    records = [SeqRecord(seq_str(codes), id=rid) for rid, codes in ordered]
    by_batch = {}
    for bg in (1, 4, 8):
        reset_launches()
        t0 = time.time()
        by_batch[bg] = model.predict(iter(records), batch_genomes=bg).to_dict()["Results"]
        e2e = time.time() - t0
        got = read_launches()
        add_launches(launches, got)
        log(f"  end-to-end [{card}] MLST predict, batch_genomes {bg}: {len(records)} records ({MLST_GENOMES} genomes of "
            f"{GENOME_LEN} bp) in {e2e:.2f} s, {MLST_GENOMES / e2e:.2f} genomes/s, {total_bases / e2e / 1e6:.2f} M bases/s; "
            f"launches K4 {got['records_wire']}, K5 {got['multi_records_query']}, K6 {got['reduce_record_counts']}")
        # every locus of this scheme takes K5's 4-word path: one K5 launch a group
        require(got["records_wire"] == got["multi_records_query"] == got["reduce_record_counts"] > 0
                and got["unpack_2bit"] == 0, "MLST predict: K4, K5 and K6 launches differ, or K1 was launched")
    require(by_batch[1] == by_batch[4] == by_batch[8] == res["Results"], "MLST: results differ between batch sizes")
    log("  MLST: batch_genomes 1, 4 and 8 and classify_mlst give identical Results")

    # sampled counts against the host: genome 0 through the group and the
    # single-genome reductions, every short record through both
    seq0 = records[0].seq
    t0 = time.time()
    want = host_mlst_totals(model, seq0, genomes[0][1], rng)
    host_s = time.time() - t0
    grouped = model._fetch_counts(model._dispatch_loci_group([seq0, records[1].seq], 1))
    single = model._fetch_counts(model._dispatch_loci(seq0, 1))
    require(all(np.array_equal(g[0], w) and np.array_equal(s, w) for g, s, w in zip(grouped, single, want)),
            "MLST: the reduced counts of genome0 differ from the host reference")
    short_seqs = [r.seq for r in records[2 : 2 + MLST_SHORT]]
    grouped = model._fetch_counts(model._dispatch_loci_group(short_seqs, 1))
    for b, (_, codes) in enumerate(shorts):
        single = model._fetch_counts(model._dispatch_loci(short_seqs[b], 1))
        for li, index in enumerate(model.indices):
            raw = host_record_counts(index, codes, 1, k=MLST_K)
            require(np.array_equal(grouped[li][b], raw) and np.array_equal(single[li], raw),
                    "MLST: the raw counts of a short record differ from the host reference")
    log(f"  MLST: thresholded totals of genome0 ([C] and [B, C] reductions, all {MLST_LOCI} loci) and raw counts of the "
        f"{MLST_SHORT} short records equal the host reference exactly (host reference {host_s:.1f} s)")

    timings = mlst_group(model, [r.seq for r in records[2 + MLST_SHORT : 6 + MLST_SHORT]], card, errors)
    model_cache.clear()
    return launches, timings


# ---------------------------------------------------------------- phase 8


def bloom_bound(words, pos, mask, num_hashes):
    """The position-based K7's bound on these inputs: ``(bytes_ms, ops_ms,
    sectors, probes)``; the positions and mask read once, each 32 B filter
    sector touched by a probe up to and with its k-mer's first clear bit
    (all probes where none is clear) read once, one count written; ~6
    operations a probe so evaluated (estimated)."""
    p = pos[mask].long() & 0xFFFFFFFF
    inside = (p >> 5) < words.numel()
    word = (words.long() & 0xFFFFFFFF)[torch.where(inside, p >> 5, 0)]
    clear = (((word >> (p & 31)) & 1) == 0) | ~inside
    first = torch.where(clear.any(dim=1), clear.int().argmax(dim=1), num_hashes - 1)
    need = torch.arange(num_hashes, device=p.device)[None, :] <= first[:, None]
    sectors = int(torch.unique(p[need & inside] >> 8).numel())  # 32 B = 256 filter bits
    probes = int(need.sum())
    nbytes = pos.numel() * 4 + mask.numel() + sectors * SECTOR_BYTES + 4
    return nbytes / HBM_BYTES_PER_S * 1e3, probes * 6 / INT_OPS_PER_S * 1e3, sectors, probes


def time_bloom_count(filt, kmers, cold=False):
    """The position-based K7 on the host-hashed positions of ``kmers``
    (hi, lo, valid) in ``filt``: its call and device-only time, its plain
    version's time, its bound, and its count against the plain version and
    ``count_hits_host`` (``err``); with ``cold``, one call's time after
    128 MB are written (the L2 holds 50 MB), outside the timed events."""
    from xspect2_tpu_torch.ops import bloom

    dev = torch.device("cuda")
    hi, lo, valid = kmers
    words = filt.device_words()
    pos = torch.from_numpy(filt._positions(hi, lo, valid).astype(np.uint32).view(np.int32)).to(dev)
    mask = torch.from_numpy(valid).to(dev)
    got = int(bloom.bloom_count(words, pos, mask))
    plain = int(bloom.bloom_count_plain(words, pos, mask))
    host = filt.count_hits_host(hi, lo, valid)
    out = timed(lambda: bloom.bloom_count(words, pos, mask), 20)
    out["plain_ms"] = cuda_ms(lambda: bloom.bloom_count_plain(words, pos, mask), 3)
    bytes_ms, ops_ms, sectors, probes = bloom_bound(words, pos, mask, filt.num_hashes)
    out.update(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes_ms=bytes_ms, ops_ms=ops_ms, sectors=sectors, probes=probes, kmers=len(hi),
               h=filt.num_hashes, hits=got, err=max(abs(got - plain), abs(got - host)))
    if cold:
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for i in range(5):
            flush.fill_(i)
            start.record()
            bloom.bloom_count(words, pos, mask)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out["cold_ms"] = float(np.mean(times))
    return out


def set_bit_positions(words, count, gen):
    """int32 [count] bit positions drawn uniformly among the set bits of
    ``words``."""
    bits = words.long() & 0xFFFFFFFF
    picked, need = [], count
    while need > 0:
        draw = torch.randint(0, words.numel() * 32, (2 * need + 64,), device=words.device, generator=gen)
        picked.append(draw[((bits[draw >> 5] >> (draw & 31)) & 1).bool()][:need])
        need -= picked[-1].numel()
    return torch.cat(picked).to(torch.int32)


def xxh3_bound(filt, codes, rec, valid, n_pos, max_records):
    """The records-route K7's bound on these inputs: the codes, record ids
    and validity read once, each 32 B filter sector a probe touches once,
    the counts written once (bytes); ~XXH3_OPS a counted window and
    ~PROBE64_OPS a probe it evaluates up to its first clear bit
    (operations).  Returns ``(bytes_ms, ops_ms, counted, probes, sectors)``."""
    from xspect2_tpu_torch.ops import bloom, query

    words = filt.device_words().long() & 0xFFFFFFFF
    seen = torch.zeros(words.numel() // 8 + 1, dtype=torch.bool, device=codes.device)
    counted = probes = 0
    for p0 in range(0, n_pos, 1 << 21):
        p1 = min(n_pos, p0 + (1 << 21))
        hi, lo, bad = query._canonical_windows_plain(codes[None, p0 : p1 + K - 1].long(), K, p1 - p0)
        r = rec[p0:p1]
        keep = valid[p0:p1] & (r >= 0) & (r < max_records) & ~bad[0]
        pos = bloom.probe_positions_plain(
            bloom.xxh3_digests_plain(hi[0, keep], lo[0, keep], K), filt.num_bits, filt.num_hashes)
        clear = ((words[pos >> 5] >> (pos & 31)) & 1) == 0
        # probes evaluated: up to and with the first clear bit, all when none is
        first = torch.where(clear.any(dim=1), clear.int().argmax(dim=1), filt.num_hashes - 1)
        used = torch.arange(filt.num_hashes, device=pos.device) <= first[:, None]
        seen[pos[used] >> 8] = True
        counted += int(keep.sum())
        probes += int(used.sum())
        del hi, lo, bad, pos, clear, used
    sectors = int(seen.sum())
    nbytes = (n_pos + K - 1) + 5 * n_pos + sectors * SECTOR_BYTES + 4 * max_records
    ops = counted * XXH3_OPS + probes * PROBE64_OPS
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3, counted, probes, sectors


def time_xxh3_batch(filt, batch):
    """The records-route K7 on one prepared batch as the model launches it:
    ``(kernel ms, plain ms, bound dict, counts, plain counts)``."""
    from xspect2_tpu_torch.ops import bloom, query

    words = filt.device_words()
    max_records = query._next_pow2(max(8, batch.num_records))
    codes, rec, valid = query.restore_records_wire(
        *query.upload_records_wire(batch, max_records, words.device), batch.num_positions, k=K, step=batch.step)
    geom = dict(max_records=max_records, k=K, num_bits=filt.num_bits, num_hashes=filt.num_hashes)
    shortest = int(np.diff(batch.offsets).min())
    got = bloom.xxh3_records_count(words, codes, rec, valid, min_record_len=shortest, **geom)
    plain = bloom.xxh3_records_count_plain(words, codes, rec, valid, **geom)
    t = timed(lambda: bloom.xxh3_records_count(words, codes, rec, valid, min_record_len=shortest, **geom), 10)
    plain_ms = cuda_ms(lambda: bloom.xxh3_records_count_plain(words, codes, rec, valid, **geom), 1, warm=False)
    b = xxh3_bound(filt, codes, rec, valid.bool(), batch.num_positions, max_records)
    bound = dict(bytes_ms=b[0], ops_ms=b[1], counted=b[2], probes=b[3], sectors=b[4])
    return t, plain_ms, bound, got[: batch.num_records], plain[: batch.num_records]


def run_xxh3_genus(genus_genome, assemblies, rng, card, errors):
    """Fit the xxh3 compat genus model on the genus genome; classify
    assemblies drawn from it and a FASTQ of 100,000 reads: K7 hashes on the
    card, one launch per record batch; every N-free window hits, counts
    equal the host's.  The filter's own count API (host hashing and the
    position-based K7) on sampled contigs.  Then the new K7 at one 4 Mbp
    assembly against its bound, its plain version and the old path (host
    hashing and one position-based K7 launch a contig), and at every batch
    of the run."""
    from xspect2_tpu_torch import classify
    from xspect2_tpu_torch.core import compat, dna
    from xspect2_tpu_torch.definitions import get_xspect_model_path
    from xspect2_tpu_torch.io.fasta import get_record_iterator
    from xspect2_tpu_torch.models.single_filter_model import ProbabilisticSingleFilterModel
    from xspect2_tpu_torch.ops import bloom, query

    base = WORK / "genus_x"
    in_dir = base / "in"
    in_dir.mkdir(parents=True)
    genome_bases = write_fasta(base / "smokex.fasta", [("smokex_genome", genus_genome[0])])
    model = ProbabilisticSingleFilterModel(
        K, "SmokeX", None, None, "Genus", get_xspect_model_path(), hash_family="xxh3", device="cuda")
    t0 = time.time()
    model.fit(base / "smokex.fasta", "SmokeX smokex")
    model.save()
    filt = model.compat_filter
    log(f"  fit [{card}]: xxh3 compat filter over {genome_bases} bases (no cut), {filt.num_bits} bits "
        f"({filt.words.nbytes / 1e6:.1f} MB), h={filt.num_hashes}, host hashing and insert {time.time() - t0:.1f} s")
    require(filt.num_hashes == 7, "the xxh3 genus filter at fpr 0.01 does not take 7 probes")

    def batches_of(path):  # the record batches predict makes of a file
        return sum(1 for _ in model._iter_record_batches(get_record_iterator(path)))

    # assemblies: one batch each
    assemblies = assemblies[:XXH3_ASSEMBLIES]
    total_bases = sum(write_fasta(in_dir / f"gasm{a}.fasta", contigs) for a, contigs in enumerate(assemblies))
    n_batches = sum(batches_of(in_dir / f"gasm{a}.fasta") for a in range(len(assemblies)))
    sampled = [sorted(contigs, key=lambda rc: len(rc[1]))[:3] for contigs in assemblies]
    out = base / "res.json"
    reset_launches()
    t0 = time.time()
    classify.classify_genus("SmokeX", in_dir, out, device="cuda")
    e2e = time.time() - t0
    # the filter's own API (the JAX package's count_hits_device): host hashing, position-based K7
    api_counts = [[filt.count_hits_sequence(seq_str(c)) for _, c in picks] for picks in sampled]
    launches = read_launches()
    log(f"  xxh3 genus: kernel launches {launches} ({n_batches} record batches)")
    require(launches["xxh3_records_count"] == launches["records_wire"] == n_batches,
            "xxh3 genus: K4 and K7 were not launched once per record batch")
    require(launches["bloom_count"] == sum(len(p) for p in sampled), "xxh3 genus: count_hits_sequence did not launch bloom_count")
    require(all(v == 0 for name, v in launches.items() if name not in
                ("xxh3_records_count", "records_wire", "bloom_count")),
            "xxh3 genus launched another path's kernel")
    checked = 0
    for a, contigs in enumerate(assemblies):
        res = json.loads((base / f"res_{a + 1}.json").read_text(encoding="utf-8"))
        require(list(res["hits"]) == [cid for cid, _ in contigs], f"xxh3 gasm{a}: contigs differ")
        for cid, c in contigs:
            bad = np.concatenate([[0], np.cumsum(c > 3)])
            starts = np.arange(0, len(c) - K + 1)
            clean = int(((bad[starts + K] - bad[starts]) == 0).sum())
            require(res["hits"][cid] == {"smokex": clean}, f"xxh3 gasm{a}: {cid} missed a window")
            require(res["num_kmers"][cid] == len(c) - K + 1, f"xxh3 gasm{a}: num_kmers of {cid}")
        for (cid, c), api in zip(sampled[a], api_counts[a]):
            host = filt.count_hits_host(*dna.canonical_kmers(c, K))
            require(res["hits"][cid]["smokex"] == host == api, f"xxh3 gasm{a}: {cid} differs from the host count")
            checked += 1
    log(f"  end-to-end [{card}] xxh3 genus assemblies: {len(assemblies)} assemblies ({total_bases} bases) in {e2e:.2f} s, "
        f"{len(assemblies) / e2e:.2f} assemblies/s, {total_bases / e2e / 1e6:.2f} M bases/s; every N-free window of "
        f"every contig hit, {checked} sampled contigs equal count_hits_host and count_hits_sequence")

    # reads: many short records a batch, shared counters
    reads, _ = simulate_reads(genus_genome, XXH3_READS, rng)
    fastq = base / "reads.fastq"
    write_fastq(fastq, reads)
    r_batches = batches_of(fastq)
    reset_launches()
    t0 = time.time()
    classify.classify_genus("SmokeX", fastq, base / "reads.json", device="cuda")
    r_e2e = time.time() - t0
    r_launches = read_launches()
    log(f"  xxh3 genus reads: kernel launches {r_launches} ({r_batches} record batches)")
    require(r_launches["xxh3_records_count"] == r_launches["records_wire"] == r_batches
            and r_launches["bloom_count"] == r_launches["unpack_2bit"] == 0,
            "xxh3 genus reads: K4 and K7 were not launched once per record batch, or K1 was launched")
    add_launches(launches, r_launches)
    hits = json.loads((base / "reads.json").read_text(encoding="utf-8"))["hits"]
    require(len(hits) == XXH3_READS, f"xxh3 genus reads: {len(hits)} records in the result")
    counts = np.array([hits[f"r{i:07d}"]["smokex"] for i in range(XXH3_READS)])
    clean = (reads <= 3).all(axis=1)
    require(bool((counts[clean] == READ_LEN - K + 1).all()), "xxh3 genus reads: a read without an N missed a window")
    sample = rng.choice(XXH3_READS, size=SAMPLE, replace=False)
    host = [filt.count_hits_host(*dna.canonical_kmers(reads[i], K)) for i in sample]
    require(np.array_equal(counts[sample], host), "xxh3 genus reads: counts differ from count_hits_host")
    log(f"  end-to-end [{card}] xxh3 genus reads: {XXH3_READS} reads in {r_e2e:.2f} s, {XXH3_READS / r_e2e:.0f} reads/s; "
        f"every read without an N hit every window, {SAMPLE} sampled reads equal count_hits_host")

    # the new K7 at one 4 Mbp assembly: time, bound, plain time; the old path on it
    contigs = assemblies[0]
    batch = query.prepare_batch(contigs, K)
    k7, plain_ms, b, got, plain = time_xxh3_batch(filt, batch)
    err = int((got - plain).abs().max())
    errors["xxh3_records_count"] = max(errors["xxh3_records_count"], err)
    require(err == 0, "xxh3_records_count disagrees with its plain version at one 4 Mbp assembly")
    bound = max(b["bytes_ms"], b["ops_ms"])
    torch.cuda.synchronize()
    t0 = time.time()
    old = [filt.count_hits_device(*dna.canonical_kmers(c, K)) for _, c in contigs]
    old_s = time.time() - t0
    require(old == got.tolist(), "the old path (host hashing, bloom_count per contig) differs from the new K7")
    log(f"  timing [{card}] xxh3_records_count (one 4 Mbp assembly: {batch.num_records} contigs, {batch.num_positions} "
        f"positions, {b['counted']} windows hashed, {b['probes']} probes evaluated): {ms_text(k7)}, bound {bound:.4f} ms "
        f"(bytes {b['bytes_ms']:.4f} with each of the {b['sectors']} filter sectors touched read once, operations "
        f"{b['ops_ms']:.4f}), plain {plain_ms:.4f} ms; the old path on the same contigs (host hashing, one "
        f"position-based launch and fetch a contig) {old_s * 1e3:.1f} ms on the host clock")

    # the position-based K7 at three shapes of the longest contig's k-mer
    # count: its own k-mers (members), seeded random DNA (non-members: some
    # probes stop early), its k-mers in a filter at fpr 2^-17 (h = 17, the
    # group loop)
    dev = torch.device("cuda")
    _, longest = max(contigs, key=lambda rc: len(rc[1]))
    member = dna.canonical_kmers(longest, K)
    f17 = compat.XXH3BloomFilter.for_items(len(member[0]), 2.0 ** -17, K, device=dev)
    f17.insert_packed(*member)
    require(f17.num_hashes == 17, "the compat filter at fpr 2^-17 does not take 17 probes")
    shapes_k7 = {
        "member": time_bloom_count(filt, member, cold=True),
        "non_member": time_bloom_count(
            filt, dna.canonical_kmers(rng.spawn(1)[0].integers(0, 4, size=len(longest), dtype=np.uint8), K)),
        "h17": time_bloom_count(f17, member),
    }
    for label, t in shapes_k7.items():
        errors["bloom_count"] = max(errors["bloom_count"], t.pop("err"))
        cold = f", one cold-L2 call {t['cold_ms']:.4f} ms (128 MB written before each)" if "cold_ms" in t else ""
        log(f"  timing [{card}] bloom_count {label} ({t['kmers']} k-mers x {t['h']} probes, {t['hits']} hit, "
            f"{t['probes']} probes up to the first clear bit): {ms_text(t)}{cold}, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: bytes {t['bytes_ms']:.4f} with each of the {t['sectors']} filter sectors those "
            f"probes touch read once, operations {t['ops_ms']:.4f}), plain {t['plain_ms']:.4f} ms")
    require(errors["bloom_count"] == 0, "bloom_count disagrees with the host count or its plain version at a timed shape")
    # the members' shape in random filters (half the bits set) of growing
    # size, every probe on a set bit: the rate of random 32 B reads as the
    # filter outgrows the 50 MB L2
    n, h = member[0].size, filt.num_hashes
    gen = torch.Generator(device=dev).manual_seed(0)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    sweep = {}
    for mb in (8, 24, 32, 64):
        w = torch.randint(-2**31, 2**31 - 1, (mb * 250_000,), dtype=torch.int32, device=dev, generator=gen)
        p = set_bit_positions(w, n * h, gen).view(n, h)
        got = int(bloom.bloom_count(w, p, ones))
        errors["bloom_count"] = max(errors["bloom_count"], abs(got - n), abs(got - int(bloom.bloom_count_plain(w, p, ones))))
        sweep[mb] = timed(lambda: bloom.bloom_count(w, p, ones), 20)["device_ms"]
        del w, p
    require(errors["bloom_count"] == 0, "bloom_count disagrees with its plain version in a random filter")
    log(f"  timing [{card}] bloom_count members ({n} x {h}) in random filters, device-only: " + "; ".join(
        f"{mb} MB {t:.4f} ms, {n * h / t / 1e6:.1f} G probes/s" if t else f"{mb} MB not measured"
        for mb, t in sweep.items()))
    words = filt.device_words()
    # its launches of the run, one per sampled contig of count_hits_sequence:
    # exact against the plain version and the host count, time less bound
    api_gap = 0.0
    for picks in sampled:
        for _, c in picks:
            c_hi, c_lo, c_valid = dna.canonical_kmers(c, K)
            p = torch.from_numpy(filt._positions(c_hi, c_lo, c_valid).astype(np.uint32).view(np.int32)).to(dev)
            m = torch.from_numpy(c_valid).to(dev)
            got = int(bloom.bloom_count(words, p, m))
            errors["bloom_count"] = max(errors["bloom_count"], abs(got - int(bloom.bloom_count_plain(words, p, m))),
                                        abs(got - filt.count_hits_host(c_hi, c_lo, c_valid)))
            api_gap += cuda_ms(lambda: bloom.bloom_count(words, p, m), 3) - max(bloom_bound(words, p, m, filt.num_hashes)[:2])
    require(errors["bloom_count"] == 0, "bloom_count disagrees at a contig of the filter's count API")

    # the new K7 at every batch of the run, at its own shape
    run_gap, shapes = 0.0, []
    for path in [in_dir / f"gasm{a}.fasta" for a in range(len(assemblies))] + [fastq]:
        for recs in model._iter_record_batches(get_record_iterator(path)):
            bt = query.prepare_batch([(r.id, dna.encode(r.seq)) for r in recs], K)
            tt, _, tb, t_got, t_plain = time_xxh3_batch(filt, bt)
            t_ms = tt["ms"]
            errors["xxh3_records_count"] = max(errors["xxh3_records_count"], int((t_got - t_plain).abs().max()))
            run_gap += t_ms - max(tb["bytes_ms"], tb["ops_ms"])
            shapes.append(f"{bt.num_records} records {t_ms:.4f} ms")
    require(errors["xxh3_records_count"] == 0, "xxh3_records_count disagrees with its plain version at a batch of the run")
    log(f"  timing [{card}] xxh3_records_count at each of its {len(shapes)} launches of the run: {'; '.join(shapes)}; "
        f"time less bound summed {run_gap:.4f} ms")
    return launches, {
        "xxh3_records_count": dict(
            k7, plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if b["bytes_ms"] >= b["ops_ms"] else "operations", library_ms=None,
            run_gap_ms=run_gap, old_path_ms=old_s * 1e3,
        ),
        "bloom_count": dict(
            {key: shapes_k7["member"][key] for key in ("ms", "device_ms", "device_by", "plain_ms", "bound_ms",
                                                        "bound_by", "cold_ms")},
            library_ms=None, run_gap_ms=api_gap,
            non_member={key: shapes_k7["non_member"][key] for key in ("ms", "device_ms", "plain_ms", "bound_ms")},
            h17={key: shapes_k7["h17"][key] for key in ("ms", "device_ms", "plain_ms", "bound_ms")},
            filter_mb_device_ms=sweep,
        ),
    }


# ---------------------------------------------------------------- sharded


def check_sharded_kernels(rng, errors):
    """K2 and K3 in owned-block mode equal their plain versions on every
    block shard (2, 3 and 4 shards, padded stacks included; K3 also on its
    global-atomic path) and the shards sum to the unsharded kernel's
    counts; class-word slices concatenate to them; K8 equals its plain
    version at 1, 2, 4 and 16 class words.  All exact."""
    from xspect2_tpu_torch.ops import query
    from xspect2_tpu_torch.ops.probe_select import probe_select, probe_select_plain
    from xspect2_tpu_torch.parallel.block_sharded import blk_table_shard
    from xspect2_tpu_torch.parallel.sharded import cls_table_shard

    dev = torch.device("cuda")
    genome = rng.integers(0, 4, size=300_000, dtype=np.uint8)

    def inputs_for(idx, step):
        reads = rng.integers(0, 4, size=(3072, 150), dtype=np.uint8)
        reads[rng.integers(0, 3072, 40), rng.integers(0, 150, 40)] = 255
        records = []
        for i in range(300):
            n = int(K + 1 + rng.pareto(1.0) * 60) if i % 7 else 5000
            at = int(rng.integers(0, len(genome) - min(n, 20_000)))
            c = genome[at : at + min(n, 20_000)].copy()
            if i % 5 == 0:
                c[rng.integers(0, len(c), 2)] = 255
            records.append((f"r{i}", c))
        batch = query.prepare_batch(records, K, step=step, chunk=1 << 16)
        max_records = query._next_pow2(max(8, batch.num_records))
        flat = [torch.from_numpy(a).to(dev) for a in (batch.codes, batch.rec_ids, batch.valid)]
        return torch.from_numpy(reads).to(dev), flat, max_records, int(np.diff(batch.offsets).min())

    padded = 0
    for num_classes, h in ((1, 3), (8, 2), (40, 7), (512, 3)):
        idx = random_index(num_classes, h, rng)
        engine = query.DeviceQueryEngine(idx, device=dev)
        for step in (1, 3):
            codes, flat, max_records, shortest = inputs_for(idx, step)
            geom = engine.geometry()
            whole2 = query.reads_query(codes, engine.table, step=step, **geom).long()
            whole3 = query.records_query(*flat, engine.table, max_records=max_records, min_record_len=shortest, **geom)
            for n_blk in (2, 3, 4):
                local = -(-idx.num_blocks // n_blk)
                padded += local * n_blk != idx.num_blocks
                sum2, sum3, err2, err3 = torch.zeros_like(whole2), torch.zeros_like(whole3), 0, 0
                for m in range(n_blk):
                    table = torch.from_numpy(blk_table_shard(idx, n_blk, m).view(np.int32)).to(dev)
                    window = dict(local_blocks=local, block_offset=m * local)
                    got2 = query.reads_query(codes, table, step=step, **geom, **window).long()
                    want2 = query.reads_query_plain(codes, table, step=step, **geom, **window).long()
                    err2 = max(err2, int((got2 - want2).abs().max()))
                    sum2 += got2
                    want3 = query.records_query_plain(*flat, table, max_records=max_records, **geom, **window)
                    for hint in (shortest, 10**6):  # 10**6: wide spans, the global-atomic path
                        got3 = query.records_query(*flat, table, max_records=max_records, min_record_len=hint, **geom, **window)
                        err3 = max(err3, int((got3 - want3).abs().max()))
                    sum3 += got3
                err2 = max(err2, int((sum2 - whole2).abs().max()))
                err3 = max(err3, int((sum3 - whole3).abs().max()))
                errors["reads_query"] = max(errors["reads_query"], err2)
                errors["records_query"] = max(errors["records_query"], err3)
                log(f"  owned-block kernels vs plain and vs the whole table: C={num_classes} P={idx.fields_per_word} "
                    f"step={step} n_blk={n_blk} ({idx.num_blocks} blocks, {local} a shard): max |err| K2 {err2}, K3 {err3}, "
                    f"hits {int(whole2.sum())} / {int(whole3.sum())}")
        # class-word slices of the unpacked tables, concatenated
        for n_cls in {40: (2,), 512: (2, 4, 16)}.get(num_classes, ()):
            codes, flat, max_records, shortest = inputs_for(idx, 1)
            geom = engine.geometry()
            whole2 = query.reads_query(codes, engine.table, step=1, **geom).long()
            whole3 = query.records_query(*flat, engine.table, max_records=max_records, min_record_len=shortest, **geom)
            cw_local = idx.class_words // n_cls
            sliced = dict(geom, class_words=cw_local, num_classes=32 * cw_local)
            parts2, parts3 = [], []
            for m in range(n_cls):
                table = torch.from_numpy(cls_table_shard(idx, n_cls, m).view(np.int32)).to(dev)
                parts2.append(query.reads_query(codes, table, step=1, **sliced).long())
                parts3.append(query.records_query(*flat, table, max_records=max_records, min_record_len=shortest, **sliced))
            err2 = int((torch.cat(parts2, dim=1)[:, :num_classes] - whole2).abs().max())
            err3 = int((torch.cat(parts3, dim=1)[:, :num_classes] - whole3).abs().max())
            errors["reads_query"] = max(errors["reads_query"], err2)
            errors["records_query"] = max(errors["records_query"], err3)
            log(f"  class-word slices vs the whole table: C={num_classes} n_cls={n_cls} ({cw_local} of "
                f"{idx.class_words} words a shard): max |err| K2 {err2}, K3 {err3}")
    require(padded > 0, "no block count of the owned-block checks needed padding")
    require(errors["reads_query"] == 0, "reads_query disagrees in owned-block mode or on class-word slices")
    require(errors["records_query"] == 0, "records_query disagrees in owned-block mode or on class-word slices")

    for cw in (1, 2, 4, 16):
        rpb = 128 // cw
        t = 100_003
        blocks = torch.from_numpy(
            rng.integers(0, 2**32, size=(t, 128), dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)
        sel = rng.integers(0, 2**32, size=(t, max(1, rpb // 32)), dtype=np.uint64)
        sel &= rng.integers(0, 2**32, size=sel.shape, dtype=np.uint64)
        sel &= (1 << min(32, rpb)) - 1
        sel[0] = 0  # no row selected: all-ones words
        selbits = torch.from_numpy(sel.astype(np.uint32).view(np.int32)).to(dev)
        got = probe_select(selbits, blocks, rows_per_block=rpb, class_words=cw)
        want = probe_select_plain(selbits, blocks, rows_per_block=rpb, class_words=cw)
        err = int((got.long() - want.long()).abs().max())
        errors["probe_select"] = max(errors["probe_select"], err)
        require(bool((got[0] == -1).all()), "probe_select: a k-mer without a selected row is not all-ones")
        log(f"  probe_select vs plain: cw={cw} rows per block {rpb}, {t} k-mers: max |err| {err}")
    require(errors["probe_select"] == 0, "probe_select disagrees with its plain version")


def sharded_classify_by_hand(clf, records, step=1):
    """Every coordinate's records step on this card, combined by hand,
    then the scores and the head as the step computes them."""
    from xspect2_tpu_torch.tools.microbench_spmd import merge_model

    batches, max_records = clf._shard_batches(records, step)
    full = [
        merge_model(clf, [clf._local_step((d, m), batches[d], max_records) for m in range(clf.n_model)])
        for d in range(clf.n_data)
    ]
    total_hits = torch.stack([f.sum(dim=0, dtype=torch.int32) for f in full]).sum(dim=0, dtype=torch.int32)
    total_kmers = torch.tensor(sum(sum(b.num_kmers) for b in batches), dtype=torch.int32, device="cuda")
    scores, pred = clf.score(total_hits, total_kmers)
    return clf.assemble(torch.stack(full).cpu().numpy(), scores.cpu().numpy(), int(pred),
                        [b.record_names for b in batches])


def collective_bound_ms(kind: str, ranks: int, nbytes: int) -> float:
    """The least time a collective over ``ranks`` cards could take on a
    tensor of ``nbytes`` a rank: the bytes a rank must receive over NVLink
    (``all_gather``: the other ranks' tensors; ``all_reduce``: twice the
    tensor less its own share, as reduce-scatter then all-gather) at the
    link's rate.  Computed from shapes; no collective has crossed cards."""
    received = (ranks - 1) * nbytes if kind == "all_gather" else 2 * (ranks - 1) * nbytes // ranks
    return received / NVLINK_BYTES_PER_S * 1e3


def time_block_shards(fn, idx, n_blk):
    """Device ms of ``fn(table, window)`` on each of ``n_blk`` block shards
    of the index's table, in coordinate order."""
    from xspect2_tpu_torch.parallel.block_sharded import blk_table_shard

    local = -(-idx.num_blocks // n_blk)
    out = []
    for m in range(n_blk):
        table = torch.from_numpy(blk_table_shard(idx, n_blk, m).view(np.int32)).to("cuda")
        window = dict(local_blocks=local, block_offset=m * local)
        out.append(cuda_ms(lambda: fn(table, window), 10))
    return out


def run_sharded_reads(kind, idx, reads, card, errors):
    """The read table on 1x2, 1x4 and 2x2 (data x blk) meshes: every
    coordinate's step for all reads, combined by hand, must equal the
    single engine exactly; ``cls`` is refused for a field-packed table.
    Then K2's time on one block shard beside the whole table's."""
    from xspect2_tpu_torch.models.filter_model import _READS_PER_CHUNK
    from xspect2_tpu_torch.ops import query
    from xspect2_tpu_torch.parallel import BlockShardedClassifier, ShardedClassifier
    from xspect2_tpu_torch.tools.microbench_spmd import coordinate_mesh, every_coordinate

    n = len(reads)
    engine = query.DeviceQueryEngine(idx, device="cuda")
    want = engine.count_hits_reads(reads, reads_per_chunk=_READS_PER_CHUNK, block=False).int()
    try:
        ShardedClassifier(idx, coordinate_mesh(1, 2, "cuda", "cls"))
    except ValueError as exc:
        log(f"  {kind}: a cls mesh is refused: {str(exc)[:60]}...")
    else:
        raise SmokeFailure(f"{kind}: a field-packed table was sharded by class words")
    for n_data, n_blk in ((1, 2), (1, 4), (2, 2)):
        clf = BlockShardedClassifier(idx, coordinate_mesh(n_data, n_blk, "cuda", "blk"))
        t0 = time.time()
        got = every_coordinate(clf, reads, _READS_PER_CHUNK)
        torch.cuda.synchronize()
        secs = time.time() - t0
        err = int((got[:n] - want[:n]).abs().max())
        require(err == 0 and int(got[n:].sum()) == 0, f"{kind}: the {n_data}x{n_blk} blk mesh differs from the single engine")
        part_bytes = got.shape[0] // n_data * got.shape[1] * 4  # one rank's int32 partial counts
        log(f"  {kind} reads on a {n_data}x{n_blk} (data x blk) mesh, {clf.local_blocks} of {idx.num_blocks} blocks "
            f"({clf.local_blocks * idx.class_words * idx.rows_per_block * 4 / 1e6:.1f} MB) a shard: {n} reads through "
            f"all {n_data * n_blk} coordinates in {secs:.2f} s, max |err| vs the single engine 0, hits {int(got.sum())}; "
            f"the all_reduce over blk ({part_bytes} B a rank) could not take less than "
            f"{collective_bound_ms('all_reduce', n_blk, part_bytes):.4f} ms between cards (not run: one card)")
        del clf, got
    codes = query.unpack_2bit(*engine.upload_wire(reads, _READS_PER_CHUNK), READ_LEN)
    geom = dict(step=1, **engine.geometry())
    whole_ms = cuda_ms(lambda: query.reads_query(codes, engine.table, **geom), 10)
    out = {}
    for n_blk in (2, 4):
        ms = time_block_shards(lambda table, window: query.reads_query(codes, table, **geom, **window), idx, n_blk)
        log(f"  timing [{card}] reads_query on one of {n_blk} block shards of the {kind} table ({len(codes)}x{READ_LEN}): "
            f"{', '.join(f'{v:.4f}' for v in ms)} ms a shard, the whole table {whole_ms:.4f} ms")
        out[n_blk] = ms
    return {"n_blk": 4, "ms": sum(out[4]) / 4, "max_ms": max(out[4]), "unsharded_ms": whole_ms,
            "n_blk_2_ms": sum(out[2]) / 2}


def run_sharded_records(asm, card, errors, ptxas_log):
    """The 40-class table: 400,000 reads on 1x2 cls, 1x2 blk and 1x4 blk
    meshes, and one 4 Mbp assembly through the records step on 2x2 blk and
    2x2 cls meshes with the SVM head, every coordinate in turn, combined
    by hand: counts equal the single engine's, per-contig hits and total
    scores equal the single-device model's, the prediction is the source
    class.  Then K3's time on one block shard and the head's (K11's) time
    and near-zero checks (``ptxas_log``: K11's compiler output)."""
    from xspect2_tpu_torch.models.filter_model import _READS_PER_CHUNK
    from xspect2_tpu_torch.ops import query
    from xspect2_tpu_torch.parallel import BlockShardedClassifier, ShardedClassifier
    from xspect2_tpu_torch.tools.microbench_spmd import coordinate_mesh, every_coordinate

    model, reads, contigs, single = asm["model"], asm["reads"], asm["contigs"], asm["single"]
    idx, engine = model.index, model.engine
    names = idx.class_names
    require(list(names) == sorted(names), "the 40-class index does not keep its classes sorted")
    head = model._get_svm(None)
    n = len(reads)
    want = engine.count_hits_reads(reads, reads_per_chunk=_READS_PER_CHUNK, block=False).int()
    for cls, axis, n_data, n_model in (
        (ShardedClassifier, "cls", 1, 2), (BlockShardedClassifier, "blk", 1, 2), (BlockShardedClassifier, "blk", 1, 4),
    ):
        clf = cls(idx, coordinate_mesh(n_data, n_model, "cuda", axis))
        t0 = time.time()
        got = every_coordinate(clf, reads, _READS_PER_CHUNK)
        torch.cuda.synchronize()
        secs = time.time() - t0
        err = int((got[:n, : idx.num_classes] - want[:n]).abs().max())
        require(err == 0 and int(got[n:].sum()) == 0 and int(got[:, idx.num_classes:].sum()) == 0,
                f"the 40-class {n_data}x{n_model} {axis} mesh differs from the single engine")
        if axis == "cls":  # each rank holds its class words of every read
            kind, part_bytes = "all_gather", got.shape[0] // n_data * (got.shape[1] // n_model) * 4
        else:
            kind, part_bytes = "all_reduce", got.shape[0] // n_data * got.shape[1] * 4
        log(f"  40-class reads on a {n_data}x{n_model} (data x {axis}) mesh, {clf.table.numel() * 4 / 1e6:.1f} MB a shard: "
            f"{n} reads through all {n_data * n_model} coordinates in {secs:.2f} s, max |err| vs the single engine 0, "
            f"hits {int(got.sum())}; the {kind} over {axis} ({part_bytes} B a rank) could not take less than "
            f"{collective_bound_ms(kind, n_model, part_bytes):.4f} ms between cards (not run: one card)")
        del clf, got
    del want

    for cls, axis in ((BlockShardedClassifier, "blk"), (ShardedClassifier, "cls")):
        clf = cls(idx, coordinate_mesh(2, 2, "cuda", axis), svm_head=head)
        t0 = time.time()
        per_record, totals, prediction = sharded_classify_by_hand(clf, contigs)
        secs = time.time() - t0
        require(list(single["hits"]) == [cid for cid, _ in contigs] and set(per_record) == set(single["hits"]),
                f"2x2 {axis}: the contigs differ from the single-device result")
        for cid, _ in contigs:
            require(per_record[cid] == {c: single["hits"][cid][c] for c in names},
                    f"2x2 {axis}: the hits of {cid} differ from the single-device model's")
        worst = max(abs(totals[c] - single["scores"]["total"][c]) for c in names)
        require(worst < 1e-6, f"2x2 {axis}: a total score differs from the single-device model's by {worst}")
        require(prediction == single["prediction"] == asm["label"], f"2x2 {axis}: predicted {prediction}, source {asm['label']}")
        log(f"  one 4 Mbp assembly ({len(contigs)} contigs) on a 2x2 (data x {axis}) mesh with the SVM head, all 4 "
            f"coordinates in {secs:.2f} s: per-contig hits equal the single-device model's, total scores within "
            f"{worst:.1e} (float32 against float64), prediction {str(prediction)!r} is the source class")
        del clf

    batch = query.prepare_batch(contigs, K, step=1, chunk=engine.chunk)
    max_records = query._next_pow2(max(8, batch.num_records))
    codes, rec, valid = query.restore_records_wire(
        *engine.upload_records_wire(batch, max_records), batch.num_positions, k=K, step=1)
    geom = dict(max_records=max_records, min_record_len=int(np.diff(batch.offsets).min()), **engine.geometry())
    whole_ms = cuda_ms(lambda: query.records_query(codes, rec, valid, engine.table, **geom), 10)
    out = {}
    for n_blk in (2, 4):
        ms = time_block_shards(
            lambda table, window: query.records_query(codes, rec, valid, table, **geom, **window), idx, n_blk)
        log(f"  timing [{card}] records_query on one of {n_blk} block shards of the 40-class table (one 4 Mbp assembly): "
            f"{', '.join(f'{v:.4f}' for v in ms)} ms a shard, the whole table {whole_ms:.4f} ms")
        out[n_blk] = ms
    x = torch.tensor([[single["scores"]["total"][c] for c in names]], dtype=torch.float32, device="cuda")
    head_timing = time_svm_head(head, x, card, errors, ptxas_log)
    return {"n_blk": 4, "ms": sum(out[4]) / 4, "max_ms": max(out[4]), "unsharded_ms": whole_ms,
            "n_blk_2_ms": sum(out[2]) / 2}, head_timing


def time_svm_head(head, x, card, errors, ptxas_log):
    """K11 at the main path's head and row ``x``, in the form its plan
    picks (through ``predict_indices``, as the main path calls it) and in
    each form forced (``forms``): its call time (``ms``) and device-only
    time beside the plain version's (the torch path the head took before
    K11) and beside an empty kernel launched on K11's block of one row
    (the floor a single call can reach); the median host clock of one
    call with its fetch; the bytes bound; the registers and spilled bytes
    ``-Xptxas -v`` gave each instantiation (score type and form).  Then
    both near-zero checks, through K11.  Timing calls are no predictions
    of the main path."""
    from xspect2_tpu_torch.models.svm_head import SVMHead
    from xspect2_tpu_torch.ops import svm_head as sh

    def host_ms(fn):
        ms = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            int(fn()[0])
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    calls, launches = SVMHead.calls, sh.svm_head.launches
    k11 = timed(lambda: head.predict_indices(x), 200)
    form = head.k11_plan.form
    forms = {}
    for each in ("staged", "global"):
        call = (lambda f=each: sh.svm_head(head, x, form=f)[0])
        forms[each] = dict(timed(call, 200), host_ms_per_call=host_ms(call))
    plain = timed(lambda: sh.svm_head_plain(head, x), 200)
    floor = timed(sh.empty_launch, 200)
    host = {"kernel": host_ms(lambda: head.predict_indices(x)), "plain": host_ms(lambda: sh.svm_head_plain(head, x)[0])}
    SVMHead.calls, sh.svm_head.launches = calls, launches
    # the head's bound: the fitted parameters (support vectors, dual
    # coefficients, intercepts) and the scores read once, the index written;
    # operations on the same basis: the kernel row, each support vector's
    # coefficients, one sign and one vote a pair (``coef``, ``sv_sq``,
    # ``starts``, the packed head's pair table and the vote matrices are the
    # head's own layouts of the parameters, not work)
    n_sv = int(head.support_vectors.shape[0])
    head_bytes = sum(b.numel() * b.element_size() for b in (head.support_vectors, head.dual_coef, head.intercept))
    head_bytes += x.numel() * x.element_size() + 8 * x.shape[0]
    head_flops = 3 * n_sv * x.shape[1] + 2 * n_sv * (len(head.classes) - 1) + 2 * len(head.pairs)
    head_bound = max(head_bytes / HBM_BYTES_PER_S, head_flops / INT_OPS_PER_S) * 1e3
    registers, spills, fn = {}, {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"svm_head_kernelI([fd])Li([01])E", line)
        if m:
            dtype = {"f": "float32", "d": "float64"}[m.group(1)]
            fn = f"{dtype} {('staged', 'global')[int(m.group(2))]}"
        elif fn is not None and "spill stores" in line:
            spills[fn] = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif fn is not None and "registers" in line:
            registers[fn] = int(re.search(r"Used (\d+) registers", line).group(1))
            fn = None
    plan = head.k11_plan
    log(f"  timing [{card}] K11 svm_head ({len(head.classes)} classes, {len(head.pairs)} pairs, {n_sv} support "
        f"vectors, {x.shape[1]} float32 scores, one row; the plan's form {form!r}, {plan.struct.staged_smem} B of "
        f"shared memory staged, {plan.struct.global_smem} B global): {ms_text(k11)}; "
        + "; ".join(f"{f} form {ms_text(t)}, host clock {t['host_ms_per_call']:.4f} ms" for f, t in forms.items())
        + f"; plain version {ms_text(plain)}; an empty kernel on K11's block {ms_text(floor)}; host clock of one "
        f"call with its fetch (median of 21) {host['kernel']:.4f} ms, plain {host['plain']:.4f} ms; bound "
        f"{head_bound:.6f} ms ({head_bytes} B once, ~{head_flops} operations at the 67 T/s rate); registers "
        f"{registers}, spilled bytes {spills} (ptxas)")
    near = {"main_head": check_head_near_zero(head, "the main path's head", tie=1e-12),
            "fitted_head": check_head_near_zero(fitted_head(len(head.classes)), "a fitted head without ties")}
    SVMHead.calls = calls
    errors["svm_head"] = max(errors["svm_head"], *(v["max_abs_err"] for v in near.values()))
    return dict(k11, plain_ms=plain["ms"], plain_device_ms=plain["device_ms"], bound_ms=head_bound, bound_by="bytes",
                launch_floor_ms=floor["ms"], launch_floor_device_ms=floor["device_ms"],
                host_ms_per_call=host["kernel"], plain_host_ms_per_call=host["plain"], form=form, forms=forms,
                registers=registers, spilled_bytes=spills, classes=len(head.classes), pairs=len(head.pairs),
                support_vectors=n_sv, near_zero=near)


def check_svm_head_kernel(errors):
    """K11 against its plain version on the card, in both forms: heads
    fitted by the port's libsvm solver at the main path's shape (40
    classes, 2 score rows a class, 40 scores) for each kernel type, in the
    staged form their plans pick and in the global form forced, and a
    seeded rbf head of 512 classes (one support vector a class, 512
    scores, 130,816 pairs, ~7 MB packed) in the global form its plan
    picks; 1, 7 and 10,000 rows in float32 and float64, the plain version
    in chunks of 1,000 rows.  Decisions within 1e-12, indices equal on the
    rows (at least 99%) whose decisions all lie 1e-9 from zero, one launch
    a call."""
    from xspect2_tpu_torch.models.svm_head import SVMHead
    from xspect2_tpu_torch.ops import svm_head as sh

    rng = np.random.default_rng(17)
    heads = {kernel: fitted_head(ASM_CLASSES, per=2, kernel=kernel) for kernel in ("linear", "rbf", "poly", "sigmoid")}
    pairs = 512 * 511 // 2
    heads["rbf, 512 classes"] = SVMHead(
        rng.random((512, 512)), rng.uniform(-1, 1, (511, 512)), rng.uniform(-0.5, 0.5, pairs), [1] * 512,
        [f"c{i:03d}" for i in range(512)], "rbf", 1 / 512).cuda()
    for name, head in heads.items():
        n_features = head.support_vectors.shape[1]
        picked = "global" if "512" in name else "staged"
        for form in ((None,) if "512" in name else (None, "global")):
            worst, rows = 0.0, 0
            for n in (1, 7, 10_000):
                x = np.clip(rng.normal(0.05, 0.02, (n, n_features)), 0, 1)
                x[np.arange(n), rng.integers(0, n_features, n)] = rng.uniform(0.4, 0.6, n)
                for dtype in (torch.float32, torch.float64):
                    xt = torch.from_numpy(x).to("cuda", dtype)
                    before = sh.svm_head.launches
                    pred, dec = sh.svm_head(head, xt, decisions=True, form=form)
                    torch.cuda.synchronize()
                    require(sh.svm_head.launches == before + 1, f"svm_head ({name}): not one launch a call")
                    require(head.k11_plan.form == picked, f"svm_head ({name}): the plan picked {head.k11_plan.form}")
                    err, settled, same = 0.0, 0, True
                    for a in range(0, n, 1000):
                        want_pred, want_dec = sh.svm_head_plain(head, xt[a:a + 1000], decisions=True)
                        err = max(err, float((dec[a:a + 1000] - want_dec).abs().max()))
                        ok = (want_dec.abs() > 1e-9).all(dim=1)
                        settled += int(ok.sum())
                        same = same and torch.equal(pred[a:a + 1000][ok], want_pred[ok])
                        del want_pred, want_dec
                    del pred, dec
                    worst, rows = max(worst, err), rows + n
                    require(err <= 1e-12 and settled >= n - n // 100 and same,
                            f"svm_head ({name}, {form or picked} form, n={n}, {dtype}) disagrees with its plain "
                            f"version: decisions off by {err}, {settled} settled rows of {n}")
            errors["svm_head"] = max(errors["svm_head"], worst)
            log(f"  svm_head vs plain, {name} ({len(head.classes)} classes, {int(head.support_vectors.shape[0])} "
                f"support vectors), {form or picked} form{' (forced)' if form else ''}: {rows} rows in float32 and "
                f"float64, decisions within {worst:.3e}, indices equal")
    del heads


def settled_rows(head, dec: torch.Tensor, tie: float) -> torch.Tensor:
    """Rows of ``dec`` whose predicted class no sign of the decisions
    within ``tie`` of zero could change: the prediction's votes with every
    such decision against it beat (or, for a later class, equal) every
    other class's votes with every such decision for it."""
    pos, neg = (dec > tie).double(), (dec < -tie).double()
    low = pos @ head.w_pos + neg @ head.w_neg
    high = low + (1 - pos - neg) @ (head.w_pos + head.w_neg)
    top = torch.argmax(pos @ head.w_pos + (1 - pos) @ head.w_neg, dim=1)[:, None]
    low_top = low.gather(1, top)
    later = torch.arange(low.shape[1])[None, :] > top
    beats = (low_top > high) | ((low_top == high) & later)
    beats.scatter_(1, top, True)
    return beats.all(dim=1)


def fitted_head(n_classes, per=5, seed=12, kernel="rbf"):
    """A head fitted by the port's libsvm solver on seeded
    hundredth-rounded score rows (own class 0.4-0.6, the rest ~0.05): its
    support vectors and intercepts are all distinct, so no decision is
    an exact tie and every near-zero row must predict the same on the
    card as on the CPU."""
    from xspect2_tpu_torch.models.svm_head import fit_ovo_svc

    rng = np.random.default_rng(seed)
    y = np.repeat(np.arange(n_classes), per)
    x = np.clip(rng.normal(0.05, 0.02, (len(y), n_classes)), 0, 1)
    x[np.arange(len(y)), y] = rng.uniform(0.4, 0.6, len(y))
    return fit_ovo_svc(np.round(x, 2), [f"c{v:02d}" for v in y], kernel, 1.0).cuda()


def per_pair_decisions(head, x: torch.Tensor) -> torch.Tensor:
    """The head's decisions summed pair by pair, as the port did before
    its batched form and as the JAX head does: class i's segment against
    ``dual_coef[j - 1]``, class j's against ``dual_coef[i]``, the
    intercept."""
    from xspect2_tpu_torch.ops.svm_head import kernel_row_plain

    x = x.to(device=head.support_vectors.device, dtype=torch.float64)
    km = kernel_row_plain(head, x)
    starts = np.concatenate([[0], np.cumsum(head.n_support)])
    return torch.stack([
        km[:, starts[i]:starts[i + 1]] @ head.dual_coef[j - 1, starts[i]:starts[i + 1]]
        + km[:, starts[j]:starts[j + 1]] @ head.dual_coef[i, starts[j]:starts[j + 1]] + head.intercept[p]
        for p, (i, j) in enumerate(head.pairs)
    ], dim=1)


def vote(head, dec: torch.Tensor) -> torch.Tensor:
    pos = (dec > 0).double()
    return torch.argmax(pos @ head.w_pos + (1 - pos) @ head.w_neg, dim=1)


def tie_flips(head, cpu, rows: np.ndarray) -> dict:
    """On every drawn row, near zero or not: how many predict otherwise
    on the card than on the CPU, for the batched head and for the
    per-pair sum; and batched against per-pair on the CPU.  Rows that
    differ can only be those with a decision within rounding of zero."""
    x = torch.from_numpy(rows)
    batched = cpu.predict_indices(x), head.predict_indices(x.cuda()).cpu()
    pairwise = vote(cpu, per_pair_decisions(cpu, x)), vote(head, per_pair_decisions(head, x.cuda())).cpu()
    return {"batched_card_vs_cpu": int((batched[0] != batched[1]).sum()),
            "per_pair_card_vs_cpu": int((pairwise[0] != pairwise[1]).sum()),
            "batched_vs_per_pair_cpu": int((batched[0] != pairwise[0]).sum())}


def check_head_near_zero(head, what, tie=None, want=100, chunk=10_000, max_chunks=40, seed=11):
    """The head on the card against the same head rebuilt on the CPU from
    its fitted parameters, on hundredth-rounded float32 rows with a
    decision below 2e-5 from zero on the CPU, where a reordered sum could
    flip a vote: half of each chunk uniform scores, half drawn between two
    support vectors.  Decisions within 1e-12 of the CPU's, predictions
    equal, on at least ``want`` such rows (up to 2,000 are held).  With
    ``tie`` None every such row is held.  A head with exact ties (the
    smoke's main path head: equal scores of two classes tie their pair)
    passes a ``tie``: its sign is rounding noise on either device, so rows
    whose prediction a decision within ``tie`` of zero could change are
    counted and left out, and the rest must have a decision between
    ``tie`` and 2e-5.  The card's calls go through K11, one launch each."""
    from xspect2_tpu_torch.models.svm_head import SVMHead
    from xspect2_tpu_torch.ops.svm_head import svm_head

    cpu = SVMHead(
        head.support_vectors.cpu().numpy(), head.dual_coef.cpu().numpy(), head.intercept.cpu().numpy(),
        head.n_support, head.classes, head.kernel, head.gamma, head.degree, head.coef0,
    )
    rng = np.random.default_rng(seed)
    sv = cpu.support_vectors.numpy()
    f32 = np.float32
    near, drawn, unsettled, flips = [], 0, 0, None
    while sum(map(len, near)) < want and drawn < chunk * max_chunks:
        half = chunk // 2
        a, b = sv[rng.integers(0, len(sv), half)], sv[rng.integers(0, len(sv), half)]
        t = rng.random((half, 1))
        rows = np.concatenate([
            rng.integers(0, 101, (half, sv.shape[1])).astype(f32) * f32(0.01),
            np.rint(100 * (t * a + (1 - t) * b)).astype(f32) * f32(0.01),
        ])
        dec = cpu.decision_values(torch.from_numpy(rows))
        mag = dec.abs()
        if tie is None:
            keep = (mag < 2e-5).any(dim=1)
        else:
            close = ((mag > tie) & (mag < 2e-5)).any(dim=1)
            settled = settled_rows(cpu, dec, tie)
            unsettled += int((close & ~settled).sum())
            keep = close & settled
        near.append(rows[keep.numpy()])
        flips = flips or tie_flips(head, cpu, rows)
        drawn += chunk
    rows = np.concatenate(near)[:2000]
    require(len(rows) >= want, f"SVM head ({what}): only {len(rows)} near-zero rows in {drawn} drawn")
    want_dec = cpu.decision_values(torch.from_numpy(rows))
    launches = svm_head.launches
    got_dec = head.decision_values(torch.from_numpy(rows).cuda()).cpu()
    err = float((got_dec - want_dec).abs().max())
    same = bool(torch.equal(head.predict_indices(torch.from_numpy(rows).cuda()).cpu(),
                            cpu.predict_indices(torch.from_numpy(rows))))
    require(svm_head.launches == launches + 2, f"SVM head ({what}): the card's calls did not go through K11")
    require(err < 1e-12 and same, f"SVM head ({what}) on the card: decisions off by {err} or predictions differ "
            "from the CPU's on near-zero rows")
    mag = want_dec.abs()
    smallest = float(mag.min() if tie is None else mag[mag > tie].min())
    left_out = "none left out" if tie is None else (
        f"{unsettled} more left out: a tie within {tie:g} could change their prediction")
    log(f"  SVM head near zero, {what} ({len(head.classes)} classes, {int(sv.shape[0])} support vectors): "
        f"{len(rows)} rows of {drawn} drawn with a decision below 2e-5 (smallest {smallest:.3e}; {left_out}); "
        f"the card's decisions within {err:.3e} of the CPU's, predictions equal on every row; of the first "
        f"{chunk} drawn, predictions that differ: {json.dumps(flips)}")
    return {"rows": len(rows), "drawn": drawn, "left_out": unsettled, "smallest": smallest, "max_abs_err": err,
            "first_chunk_flips": flips}


def run_nccl_world_of_one(asm, card):
    """``distributed.initialize`` with NCCL on this card at world size 1,
    then both classifiers through their public methods on a 1x1 mesh:
    every collective runs through NCCL, the counts equal the engine's and
    the classification the single-device model's.  Returns the kernel
    launches of these runs and K2's time and bound at their shape."""
    import torch.distributed as dist

    from xspect2_tpu_torch.models.svm_head import SVMHead
    from xspect2_tpu_torch.ops import query
    from xspect2_tpu_torch.parallel import (
        BlockShardedClassifier, ShardedClassifier, distributed, make_block_mesh, make_mesh,
    )

    model, contigs, single = asm["model"], asm["contigs"], asm["single"]
    idx = model.index
    reads = asm["reads"][:100_000]
    want = model.engine.count_hits_reads(reads)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = WORK / "nccl_store"
    t0 = time.time()
    topo = distributed.initialize(f"file://{store}", num_processes=1, process_id=0, timeout_s=120)
    require(dist.get_backend() == "nccl" and topo["process_count"] == 1, f"not an NCCL world of one: {topo}")
    log(f"  NCCL world of one on this card in {time.time() - t0:.2f} s: {topo}")
    calls = SVMHead.calls
    reset_launches()
    try:
        for cls, make in ((ShardedClassifier, make_mesh), (BlockShardedClassifier, make_block_mesh)):
            mesh = make()
            require(mesh.coords == (0, 0) and all(g is not None for g in mesh.groups.values()),
                    "the 1x1 mesh has no NCCL process groups")
            # replicate_out=True: the data-axis all_gather runs as well
            clf = cls(idx, mesh, svm_head=model._get_svm(None), replicate_out=True)
            t0 = time.time()
            got = clf.count_hits_reads(reads, reads_per_chunk=4096)
            local = clf.count_hits_reads_local(reads, reads_per_chunk=4096)
            per_record, totals, prediction = clf.classify(contigs)
            secs = time.time() - t0
            require(np.array_equal(got, want) and np.array_equal(local, want),
                    f"{cls.__name__} at NCCL world size 1 differs from the engine")
            require(all(per_record[cid] == {c: single["hits"][cid][c] for c in idx.class_names} for cid, _ in contigs),
                    f"{cls.__name__}.classify at NCCL world size 1 differs from the single-device model")
            require(max(abs(totals[c] - single["scores"]["total"][c]) for c in idx.class_names) < 1e-6
                    and prediction == asm["label"], f"{cls.__name__}.classify: wrong scores or prediction")
            log(f"  {cls.__name__} on a 1x1 mesh, NCCL collectives: count_hits_reads and count_hits_reads_local "
                f"({len(reads)} reads) equal the engine, classify (one 4 Mbp assembly) equals the single-device "
                f"model and predicts {str(prediction)!r}; {secs:.2f} s")
            del clf
    finally:
        dist.destroy_process_group()
    launches = read_launches()
    log(f"  sharded public methods: kernel launches {launches}; SVM head calls {SVMHead.calls - calls}")
    require(launches["unpack_2bit"] == launches["reads_query"] > 0
            and launches["records_wire"] == launches["records_query"] > 0,
            "the sharded path did not launch K1 once per K2 launch and K4 once per K3 launch")
    engine = model.engine
    codes = query.unpack_2bit(*engine.upload_wire(reads, 4096), READ_LEN)
    k2 = time_reads_launch("the shape of these runs: the 40-class table", idx, codes, engine.table,
                           dict(step=1, **engine.geometry()), card)
    return launches, k2


# ---------------------------------------------------------------- phase 9


def run_microbench(card, errors):
    """The probe-select microbenchmark at its default shape (a 50 MB table,
    8 classes, 7 probes, 65,536 reads in chunks of 8,192), then K8 at one
    chunk's shape: time, bound, plain time; and K2 at the shape the
    microbenchmark launches it (one pass of 65,536 reads): time, bound."""
    from xspect2_tpu_torch.core.hashing import block_words_fieldbase_torch
    from xspect2_tpu_torch.ops import query
    from xspect2_tpu_torch.ops.probe_select import probe_select, probe_select_plain
    from xspect2_tpu_torch.tools import microbench_probe as mb

    reset_launches()
    res = mb.run()
    launches = read_launches()
    require(res["equal"], "the microbenchmark's two formulations disagree")
    require(launches["probe_select"] > 0 and launches["reads_query"] > 0, "the microbenchmark did not launch K8 and K2")
    log(f"  microbenchmark [{card}]: reads_query {res['reads_query_reads_per_s']:.0f} reads/s, gather + probe_select "
        f"{res['probe_select_reads_per_s']:.0f} reads/s; launches {launches}")

    geom = mb.geometry(8, 7, 50.0)
    rpb, cw = geom["rows_per_block"], geom["class_words"]
    rng = np.random.default_rng(1)
    table = torch.from_numpy(
        rng.integers(0, 2**32, size=(geom["num_blocks"], 128), dtype=np.uint64).astype(np.uint32).view(np.int32)).to("cuda")
    reads = torch.from_numpy(rng.integers(0, 4, size=(8192, READ_LEN), dtype=np.uint8)).to("cuda")
    hi, lo, _ = query._canonical_windows_plain(reads.long(), K, READ_LEN - K + 1)
    block, rows, _ = block_words_fieldbase_torch(hi.reshape(-1), lo.reshape(-1), geom["num_blocks"], rpb, 7)
    selbits = mb.pack_row_mask(rows, rpb)
    blocks = table.index_select(0, block)
    del hi, lo, rows
    t = blocks.shape[0]
    got = probe_select(selbits, blocks, rows_per_block=rpb, class_words=cw)
    want = probe_select_plain(selbits, blocks, rows_per_block=rpb, class_words=cw)
    errors["probe_select"] = max(errors["probe_select"], int((got.long() - want.long()).abs().max()))
    require(errors["probe_select"] == 0, "probe_select disagrees with its plain version at the microbenchmark's shape")
    del want
    k8 = timed(lambda: probe_select(selbits, blocks, rows_per_block=rpb, class_words=cw), 20)
    k8_plain = cuda_ms(lambda: probe_select_plain(selbits, blocks, rows_per_block=rpb, class_words=cw), 2)
    gather_ms = cuda_ms(lambda: table.index_select(0, block), 10)
    k8_bytes = t * (512 + 4 * selbits.shape[1] + 4 * cw)
    k8_bound = k8_bytes / HBM_BYTES_PER_S * 1e3
    k8_ops_ms = t * 128 * 3 / INT_OPS_PER_S * 1e3  # estimated: select, AND and shuffle per word
    mb_reads = torch.from_numpy(rng.integers(0, 4, size=(65_536, READ_LEN), dtype=np.uint8)).to("cuda")
    mb_idx = SimpleNamespace(num_blocks=geom["num_blocks"], rows_per_block=rpb, class_words=cw, num_hashes=7,
                             fields_per_word=1)
    k2 = time_reads_launch("the microbenchmark's 50 MB table, one pass", mb_idx, mb_reads, table,
                           dict(step=1, **geom), card)
    log(f"  timing [{card}] probe_select ([{t}, 128] blocks, {selbits.shape[1]} mask words, cw={cw}; one chunk of 8,192 "
        f"reads): {ms_text(k8)}, bound {max(k8_bound, k8_ops_ms):.4f} ms (bytes {k8_bound:.4f}: {k8_bytes} B once; "
        f"operations {k8_ops_ms:.4f}), plain {k8_plain:.4f} ms; the gather that feeds it (index_select) {gather_ms:.4f} ms")
    return launches, {
        "probe_select": dict(
            k8, plain_ms=k8_plain, bound_ms=max(k8_bound, k8_ops_ms),
            bound_by="bytes" if k8_bound >= k8_ops_ms else "operations", library_ms=None,
        ),
    }, k2


# ---------------------------------------------------------------- phase 10


def cli_run(args, device, root):
    """``args`` through the port's click CLI in this process, with the root
    ``--device`` and the data root ``root``; the CLI module is reloaded
    first, as its model choices are read from the registry at import."""
    import importlib
    import traceback

    from click.testing import CliRunner

    import xspect2_tpu_torch.main as main_mod

    os.environ["XSPECT_DATA_ROOT"] = str(root)
    cli = importlib.reload(main_mod).cli
    r = CliRunner().invoke(cli, ["--device", device, *[str(a) for a in args]])
    require(r.exit_code == 0, f"CLI {' '.join(map(str, args))} (--device {device}): exit {r.exit_code}\n{r.output[-2000:]}"
            + ("".join(traceback.format_exception(*r.exc_info)) if r.exc_info else ""))
    return r.output


def tree_files(root: Path, uuids: bool = False) -> dict:
    """{relative path: bytes} of every file under ``root``; with ``uuids``
    each uuid4 in a path or a file (``all`` draws one a run) is replaced."""
    text, raw = PRODUCT_UUID
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            rel, data = str(p.relative_to(root)), p.read_bytes()
            out[text.sub("<uuid>", rel) if uuids else rel] = raw.sub(b"<uuid>", data) if uuids else data
    return out


def require_same_tree(got: Path, want: Path, what: str, uuids: bool = False) -> int:
    """Both trees hold the same files, byte for byte; returns the file count."""
    a, b = tree_files(got, uuids), tree_files(want, uuids)
    require(a and sorted(a) == sorted(b), f"{what}: the files differ: {sorted(a)} against {sorted(b)}")
    differ = [rel for rel in a if a[rel] != b[rel]]
    require(not differ, f"{what}: the card's files differ from the CPU's: {differ}")
    return len(a)


def require_kernels(launches: dict, names, what: str, absent=()) -> None:
    """Each kernel of ``names`` launched, none of ``absent``."""
    require(all(launches[n] > 0 for n in names) and all(launches[n] == 0 for n in absent),
            f"{what}: launches {launches} miss one of {list(names)} or include one of {list(absent)}")


def delta(before: dict, after: dict) -> dict:
    return {name: after[name] - before[name] for name in KERNELS}


@contextmanager
def step_probes(record: dict, *targets):
    """Wrap each (module, function name) so that its calls' seconds and
    kernel launches add up in ``record[name]``; the CLI looks these
    functions up on their modules when it runs, so its steps are timed.
    Each step ends with its results on the host (a JSON or FASTA file)."""
    saved = []
    for module, name in targets:
        fn = getattr(module, name)

        def probe(*args, _fn=fn, _name=name, **kwargs):
            before, t0 = read_launches(), time.time()
            try:
                return _fn(*args, **kwargs)
            finally:
                entry = record.setdefault(_name, {"calls": 0, "s": 0.0, "launches": {n: 0 for n in KERNELS}})
                entry["calls"] += 1
                entry["s"] += time.time() - t0
                add_launches(entry["launches"], delta(before, read_launches()))

        setattr(module, name, probe)
        saved.append((module, name, fn))
    try:
        yield record
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


@contextmanager
def loopback_only(blocked: list):
    """Within: no name but localhost resolves (no DNS query is sent) and no
    socket connects to an address other than 127.0.0.1 or ::1; each attempt
    is refused and appended to ``blocked``."""
    import socket

    real_getaddrinfo, real_connect = socket.getaddrinfo, socket.socket.connect
    local = ("localhost", "127.0.0.1", "::1", b"localhost", b"127.0.0.1", b"::1", None)

    def getaddrinfo(host, *args, **kwargs):
        if host not in local:
            blocked.append(f"resolve {host!r}")
            raise socket.gaierror(socket.EAI_NONAME, f"{host!r} is not resolved: the smoke stays on this machine")
        return real_getaddrinfo(host, *args, **kwargs)

    def connect(self, address):
        if self.family in (socket.AF_INET, socket.AF_INET6) and address[0] not in local:
            blocked.append(f"connect {address!r}")
            raise OSError(f"connect to {address!r} refused: the smoke stays on this machine")
        return real_connect(self, address)

    socket.getaddrinfo, socket.socket.connect = getaddrinfo, connect
    try:
        yield blocked
    finally:
        socket.getaddrinfo, socket.socket.connect = real_getaddrinfo, real_connect


@contextmanager
def requests_state(available: bool):
    """Within: ``requests`` importable (``available``), or not, together with
    the port's handler modules that hold it, so that the MLST ST-name
    lookup fails at its import and yields the offline name (as in phase
    7).  The modules' state before is restored after."""
    def held():
        return [m for m in sys.modules if m == "requests" or m.startswith("xspect2_tpu_torch.handlers.")]

    saved = {m: sys.modules[m] for m in held()}
    for m in held():
        del sys.modules[m]
    if not available:
        sys.modules["requests"] = None
    try:
        yield
    finally:
        for m in held():
            del sys.modules[m]
        sys.modules.update(saved)


def run_demo(base: Path, card: str):
    """(a) The port's ``tools/demo_e2e.py`` on the card at the species
    headline's genome size: ``models train directory --meta`` (K4 + K3 for
    the SVM scoring), then ``all`` on the read file (K1 + K2 in the genus
    filter and in the species step).  Returns its kept directory and the
    seconds of the demo, of ``all`` (the demo's clock) and of each step."""
    import tempfile

    from xspect2_tpu_torch import classify, filter_sequences, train
    from xspect2_tpu_torch.tools import demo_e2e

    class Tee(io.StringIO):
        def write(self, text):
            sys.__stdout__.write(text)
            return super().write(text)

    steps, printed = {}, Tee()
    (base / "demo").mkdir(parents=True)
    saved_tempdir, tempfile.tempdir = tempfile.tempdir, str(base / "demo")
    t0 = time.time()
    try:
        with step_probes(steps, (train, "train_from_directory"), (filter_sequences, "filter_genus"),
                         (classify, "classify_species"), (classify, "classify_mlst")), redirect_stdout(printed):
            demo = demo_e2e.main(["--genome-mb", str(DEMO_GENOME_MB), "--reads", str(DEMO_READS), "--keep",
                                  "--device", "cuda"])
    finally:
        tempfile.tempdir = saved_tempdir
    total = time.time() - t0
    # the demo's own clock around each CLI command
    all_s = float(re.search(r"^  all in ([0-9.]+) s$", printed.getvalue(), re.MULTILINE).group(1))
    (species_json,) = (demo / "out").glob("species_classification_*.json")
    prediction = json.loads(species_json.read_text(encoding="utf-8"))["prediction"]
    require(prediction == "470", f"the demo predicted {prediction!r}, not 470")
    require_kernels(steps["train_from_directory"]["launches"], ("records_wire", "records_query"),
                    "the demo's training (the SVM scoring)")
    for name in ("filter_genus", "classify_species"):
        require(steps[name]["calls"] == 1, f"the demo's all ran {name} {steps[name]['calls']} times")
        require_kernels(steps[name]["launches"], ("unpack_2bit", "reads_query"), f"the demo's all ({name})",
                        absent=("records_wire", "records_query"))
    require("classify_mlst" not in steps, "the demo ran MLST without an abaumannii scheme")
    log(f"  (a) demo [{card}]: {DEMO_GENOME_MB} Mbp genomes, {DEMO_READS} reads, exit 0, species prediction "
        f"{prediction}, whole demo {total:.2f} s; training {steps['train_from_directory']['s']:.2f} s, all "
        f"{all_s:.2f} s ({DEMO_READS / all_s:.0f} reads/s): genus filter {steps['filter_genus']['s']:.2f} s, species "
        f"step {steps['classify_species']['s']:.2f} s; launches "
        + json.dumps({k: {n: v for n, v in e['launches'].items() if v} for k, e in steps.items()}))
    return demo, dict(demo_s=total, all_s=all_s, **{k: e["s"] for k, e in steps.items()})


def read_subset(sample: Path, out: Path, starts) -> int:
    """PRODUCT_PARITY_READS / len(starts) reads from each start, in file order."""
    from xspect2_tpu_torch.io.fasta import parse_fasta
    from xspect2_tpu_torch.io.fasta import write_fasta as write_records

    per = PRODUCT_PARITY_READS // len(starts)
    records = list(parse_fasta(sample))
    picked = [r for s in starts for r in records[s : s + per]]
    write_records(picked, out)
    return len(picked)


def run_card_and_cpu(base: Path, demo: Path, card: str):
    """(b) The demo's registry and 6,000 of its reads (the first 2,000 of
    each source, 470, 471 and off-genus noise): ``all``, ``filter genus`` and
    ``filter species`` (``-t -1`` and ``-t 0.5``) through the CLI with
    ``--device cuda`` and with ``--device cpu``, in this process (the model
    cache holds both devices' models); every output directory must be
    byte-identical.  Returns the subset's path."""
    subset = base / "subset.fasta"
    n = read_subset(demo / "sample.fasta", subset, (0, DEMO_READS // 2, DEMO_READS // 2 + DEMO_READS // 3))
    commands = {
        "all": ["all", "-g", "Testus", "-i", subset, "-o", "{out}", "-t", "0.5"],
        "filter genus": ["filter", "genus", "-g", "Testus", "-i", subset, "-o", "{out}/genus_filtered.fasta",
                         "--classification-output-path", "{out}/genus.json", "-t", "0.5"],
        "filter species 470 -t -1": ["filter", "species", "-g", "Testus", "-s", "470", "-i", subset,
                                 "-o", "{out}/species_filtered.fasta", "--classification-output-path",
                                 "{out}/species.json", "-t", "-1"],
        "filter species 471 -t 0.5": ["filter", "species", "-g", "Testus", "-s", "471", "-i", subset,
                                  "-o", "{out}/species_filtered.fasta", "--classification-output-path",
                                  "{out}/species.json", "-t", "0.5"],
    }
    for c, (what, args) in enumerate(commands.items()):
        outs, seconds = {}, {}
        for device in ("cuda", "cpu"):
            outs[device] = base / f"b{c}_{device}"
            outs[device].mkdir()
            before, t0 = read_launches(), time.time()
            cli_run([str(a).replace("{out}", str(outs[device])) for a in args], device, demo)
            seconds[device] = time.time() - t0
            got = delta(before, read_launches())
            if device == "cuda":
                require_kernels(got, ("unpack_2bit", "reads_query"), f"(b) {what} on the card",
                                absent=("records_wire", "records_query"))
                cuda_launches = got
            else:
                require(not any(got.values()), f"(b) {what} on the CPU launched {got}")
        files = require_same_tree(outs["cuda"], outs["cpu"], f"(b) {what}", uuids=(what == "all"))
        log(f"  (b) {what} [{card}]: {n} reads, card {seconds['cuda']:.2f} s (launches "
            f"{ {k: v for k, v in cuda_launches.items() if v} }), CPU {seconds['cpu']:.2f} s; {files} files "
            f"byte-identical")
    return subset


def mlst_scheme(scheme_dir: Path, genome: str, rng) -> None:
    """PRODUCT_LOCI loci of PRODUCT_ALLELES alleles of ALLELE_LEN bp:
    allele 1 of each locus is cut from ``genome`` (one locus every
    PRODUCT_CONTIG_LEN bases, so that each contig of the c2 sample holds
    one), the others are random."""
    for li in range(PRODUCT_LOCI):
        at = li * PRODUCT_CONTIG_LEN + PRODUCT_CONTIG_LEN // 2
        locus = scheme_dir / f"Oxf_gene{li}"
        locus.mkdir(parents=True)
        seqs = [genome[at : at + ALLELE_LEN]] + [
            seq_str(rng.integers(0, 4, size=ALLELE_LEN, dtype=np.uint8)) for _ in range(PRODUCT_ALLELES - 1)]
        for a, seq in enumerate(seqs):
            (locus / f"Allele_ID_{a + 1}.fasta").write_text(f">Oxf_gene{li}_{a + 1}\n{seq}\n", encoding="utf-8")


def mock_services():
    """``tests/mock_services.py`` (the standard library and numpy only: a
    mock of NCBI Datasets and PubMLST on 127.0.0.1), loaded from its file:
    a ``tests`` package elsewhere on the path may hide this one."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("xspect_mock_services", ROOT / "tests" / "mock_services.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_mlst_product(base: Path, demo: Path, rng, card: str):
    """(c1) ``models train mlst`` for the mock PubMLST's ``testorg`` scheme
    on the card and on the CPU: the model files must be byte-identical.
    (c2) An ``abaumannii`` scheme registered in the demo's registry from
    local allele files (allele 1 of each locus cut from the demo's 470
    genome), then ``all`` on contigs of that genome: the species step
    predicts 470, so step 3 runs ``classify_mlst`` (K4 + K5 + K6); the
    outputs on the card and on the CPU must be byte-identical."""
    from xspect2_tpu_torch import classify
    from xspect2_tpu_torch.definitions import get_xspect_model_path
    from xspect2_tpu_torch.io.fasta import SeqRecord, parse_fasta
    from xspect2_tpu_torch.io.fasta import write_fasta as write_records
    from xspect2_tpu_torch.models.mlst_model import ProbabilisticFilterMlstSchemeModel

    services = mock_services()
    with requests_state(available=True), services.MockServices() as mock:
        os.environ["XSPECT_PUBMLST_URL"] = f"{mock.url}/db"
        seconds = {}
        for device in ("cuda", "cpu"):
            before, t0 = read_launches(), time.time()
            cli_run(["models", "train", "mlst", "--organism", services.MLST_ORGANISM,
                     "--mlst-scheme", services.MLST_SCHEME], device, base / f"c1_{device}")
            seconds[device] = time.time() - t0
            require(not any(delta(before, read_launches()).values()), "(c1) MLST training launched a kernel")
        served = len(mock.server.requests)
    files = require_same_tree(base / "c1_cuda" / "models", base / "c1_cpu" / "models", "(c1) train mlst")
    require(served > 0, "(c1) the mock PubMLST served no request")
    log(f"  (c1) models train mlst [{card}]: {services.MLST_ORGANISM} {services.MLST_SCHEME!r} from the loopback "
        f"mock ({served} requests), card {seconds['cuda']:.2f} s, CPU {seconds['cpu']:.2f} s; {files} model files "
        f"byte-identical")

    os.environ["XSPECT_DATA_ROOT"] = str(demo)
    (genome,) = [r.seq for r in parse_fasta(demo / "train" / "cobs" / "470" / "470.fasta")]
    mlst_scheme(base / "abaumannii", genome, rng)
    t0 = time.time()
    model = ProbabilisticFilterMlstSchemeModel(
        MLST_K, "Oxford", get_xspect_model_path(), "http://127.0.0.1:9/db/pubmlst_abaumannii_seqdef/schemes/1",
        "abaumannii", device="cuda")
    model.fit(base / "abaumannii")
    model.save()
    fit_s = time.time() - t0
    del model
    sample = base / "c2_sample.fasta"
    write_records([SeqRecord(genome[c * PRODUCT_CONTIG_LEN : (c + 1) * PRODUCT_CONTIG_LEN], f"contig{c}")
                   for c in range(PRODUCT_LOCI)], sample)
    steps, seconds = {}, {}
    with requests_state(available=False), step_probes(steps, (classify, "classify_mlst")):
        for device in ("cuda", "cpu"):
            before, t0 = read_launches(), time.time()
            cli_run(["all", "-g", "Testus", "-i", sample, "-o", base / f"c2_{device}", "-t", "0.5"], device, demo)
            seconds[device] = time.time() - t0
            if device == "cuda":
                got = delta(before, read_launches())
                require(steps.get("classify_mlst", {}).get("calls") == 1, "(c2) all did not run classify_mlst")
                require_kernels(steps["classify_mlst"]["launches"],
                                ("records_wire", "multi_records_query", "reduce_record_counts"),
                                "(c2) all's MLST step on the card")
    files = require_same_tree(base / "c2_cuda", base / "c2_cpu", "(c2) all with MLST", uuids=True)
    (mlst_json,) = (base / "c2_cuda").glob("mlst_classification_*.json")
    res = json.loads(mlst_json.read_text(encoding="utf-8"))["Results"]
    for li in range(PRODUCT_LOCI):
        strain = res[f"contig{li}"][0]["Strain type"]
        require(next(iter(strain[f"Oxf_gene{li}"])) == "Allele_ID_1", f"(c2) contig{li} misses allele 1 of its locus")
    st_name = res["contig0"][0]["Strain type"]["ST_Name"]
    require(str(st_name).startswith("N/A (PubMLST lookup failed:"), f"(c2) ST_Name {st_name!r}")
    log(f"  (c2) all with MLST step 3 [{card}]: scheme of {PRODUCT_LOCI} loci x {PRODUCT_ALLELES} alleles fitted in "
        f"{fit_s:.2f} s; {PRODUCT_LOCI} contigs of {PRODUCT_CONTIG_LEN} bp of the 470 genome, card "
        f"{seconds['cuda']:.2f} s "
        f"(classify_mlst {steps['classify_mlst']['s']:.2f} s over both devices; launches "
        f"{ {k: v for k, v in got.items() if v} }), CPU {seconds['cpu']:.2f} s; {files} files byte-identical; every "
        f"contig calls allele 1 of its locus; ST_Name {st_name!r}")


def run_ncbi_product(base: Path, card: str):
    """(d) ``models train ncbi -g Testus`` through the loopback mock NCBI on
    the card and on the CPU (the SVM scoring: K4 + K3): the model files
    must be byte-identical."""
    seconds = {}
    with requests_state(available=True), mock_services().MockServices() as mock:
        os.environ["XSPECT_NCBI_URL"] = mock.url
        for device in ("cuda", "cpu"):
            before, t0 = read_launches(), time.time()
            cli_run(["models", "train", "ncbi", "-g", "Testus"], device, base / f"d_{device}")
            seconds[device] = time.time() - t0
            if device == "cuda":
                got = delta(before, read_launches())
                require_kernels(got, ("records_wire", "records_query"), "(d) train ncbi on the card")
        served = len(mock.server.requests)
    os.environ["XSPECT_NCBI_URL"] = "http://127.0.0.1:1"
    files = require_same_tree(base / "d_cuda" / "models", base / "d_cpu" / "models", "(d) train ncbi")
    log(f"  (d) models train ncbi [{card}]: Testus from the loopback mock ({served} requests), card "
        f"{seconds['cuda']:.2f} s (launches { {k: v for k, v in got.items() if v} }), CPU {seconds['cpu']:.2f} s; "
        f"{files} model files byte-identical")


def run_pangenome_product(base: Path, rng, card: str):
    """(e) ``pipelines.train_pangenome`` over two genera in the
    ``train_from_directory`` layout, then ``grid_search_model`` on one
    trained species model's ``scores.csv``, on the card and on the CPU:
    model files byte-identical, results equal."""
    from xspect2_tpu_torch import pipelines
    from xspect2_tpu_torch.model_management import get_species_model_path
    from xspect2_tpu_torch.models.svm_head import SVMHead
    from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel
    from xspect2_tpu_torch.pipelines.score_svm import grid_search_model

    layout = base / "pangenome"
    for genus in PANGENOME_GENERA:
        for s in range(PANGENOME_SPECIES):
            label = f"{genus}{s}"
            codes = rng.integers(0, 4, size=PANGENOME_GENOME_LEN, dtype=np.uint8)
            for sub in ("cobs", "svm"):
                (layout / genus / sub / label).mkdir(parents=True)
            write_fasta(layout / genus / "cobs" / label / f"{label}.fasta", [(label, codes)])
            for i in range(2):
                noisy = codes.copy()
                at = rng.integers(0, len(noisy), size=len(noisy) // 100)
                noisy[at] = rng.integers(0, 4, size=len(at), dtype=np.uint8)
                write_fasta(layout / genus / "svm" / label / f"{label}_svm{i}.fasta", [(f"{label}_svm{i}", noisy)])
    results, grids, seconds = {}, {}, {}
    for device in ("cuda", "cpu"):
        os.environ["XSPECT_DATA_ROOT"] = str(base / f"e_{device}")
        before, t0 = read_launches(), time.time()
        results[device] = pipelines.train_pangenome(list(PANGENOME_GENERA), data_root=layout, device=device)
        train_s = time.time() - t0
        if device == "cuda":
            got = delta(before, read_launches())
            require_kernels(got, ("records_wire", "records_query"), "(e) train_pangenome on the card")
        model = ProbabilisticFilterSVMModel.load(get_species_model_path(PANGENOME_GENERA[0]), device=device)
        calls, t0 = SVMHead.calls, time.time()
        grids[device] = grid_search_model(model, device=device)
        seconds[device] = (train_s, time.time() - t0, SVMHead.calls - calls)
        del model
    require(results["cuda"] == results["cpu"] == {g: "ok" for g in PANGENOME_GENERA},
            f"(e) train_pangenome results: card {results['cuda']}, CPU {results['cpu']}")
    files = require_same_tree(base / "e_cuda" / "models", base / "e_cpu" / "models", "(e) train_pangenome")
    require(grids["cuda"] == grids["cpu"], f"(e) grid_search_model: card {grids['cuda']}, CPU {grids['cpu']}")
    log(f"  (e) train_pangenome [{card}]: {len(PANGENOME_GENERA)} genera x {PANGENOME_SPECIES} species of "
        f"{PANGENOME_GENOME_LEN} bp, card {seconds['cuda'][0]:.2f} s (launches "
        f"{ {k: v for k, v in got.items() if v} }), CPU {seconds['cpu'][0]:.2f} s; {files} model files "
        f"byte-identical; grid_search_model ({seconds['cuda'][2]} head predictions) card {seconds['cuda'][1]:.2f} s, "
        f"CPU {seconds['cpu'][1]:.2f} s, equal: best {grids['cuda'][0]}")


# a subprocess that runs CLI commands (a JSON list of argument lists) in
# turn and prints, for each, its seconds and the launches of the records
# and reads kernels
CLI_PROBE = """
import json, sys, time
from xspect2_tpu_torch import main
from xspect2_tpu_torch.ops import query
names = ("unpack_2bit", "reads_query", "records_wire", "records_query")
out = []
for args in json.loads(sys.argv[1]):
    before = {n: getattr(query, n).launches for n in names}
    t0 = time.perf_counter()
    main.cli.main(args, standalone_mode=False)
    out.append({"s": time.perf_counter() - t0,
                "launches": {n: getattr(query, n).launches - before[n] for n in names}})
print(json.dumps(out))
"""


def cli_probe(commands, demo: Path, no_native: bool) -> list:
    env = {**os.environ, "XSPECT_DATA_ROOT": str(demo), "XSPECT_NCBI_URL": "http://127.0.0.1:1",
           "XSPECT_PUBMLST_URL": "http://127.0.0.1:1"}
    env.pop("XSPECT_NO_NATIVE", None)
    if no_native:
        env["XSPECT_NO_NATIVE"] = "1"
    proc = subprocess.run([sys.executable, "-c", CLI_PROBE, json.dumps([[str(a) for a in c] for c in commands])],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=900, check=False)
    require(proc.returncode == 0, f"(f) CLI subprocess failed ({proc.returncode}): {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run_no_native(base: Path, demo: Path, subset: Path, card: str):
    """(f) ``classify species`` in subprocesses with ``XSPECT_NO_NATIVE=1``
    (read at the native library's first load): on the card the uniform
    150 bp subset takes K4 + K3, not K1 + K2, and its JSON equals the
    CPU's byte for byte and the native route's; the demo's whole sample
    through both routes on the card, twice each, gives their reads/s."""
    def species(device, path, out):
        return ["--device", device, "classify", "species", "-g", "Testus", "-i", path, "-o", base / out]

    sample = demo / "sample.fasta"
    reps = [species("cuda", sample, f"f_rate_{r}.json") for r in range(2)]
    t0 = time.time()
    off = cli_probe([species("cuda", subset, "f_off_cuda.json"), *reps], demo, no_native=True)
    off_cpu = cli_probe([species("cpu", subset, "f_off_cpu.json")], demo, no_native=True)
    on = cli_probe([species("cuda", subset, "f_on_cuda.json"), *reps], demo, no_native=False)
    wall = time.time() - t0
    for run in off:
        require_kernels(run["launches"], ("records_wire", "records_query"), "(f) XSPECT_NO_NATIVE on the card",
                        absent=("unpack_2bit", "reads_query"))
    for run in on:
        require_kernels(run["launches"], ("unpack_2bit", "reads_query"), "(f) the native route on the card",
                        absent=("records_wire", "records_query"))
    off_json = (base / "f_off_cuda.json").read_bytes()
    require(off_json == (base / "f_off_cpu.json").read_bytes(),
            "(f) XSPECT_NO_NATIVE: the card's JSON differs from the CPU's")
    require(off_json == (base / "f_on_cuda.json").read_bytes(),
            "(f) the records route's JSON differs from the reads route's")
    require(not any(off_cpu[0]["launches"].values()), f"(f) the CPU's subprocess launched {off_cpu[0]['launches']}")
    launches = {n: 0 for n in KERNELS}
    for run in off + on:
        add_launches(launches, run["launches"])
    rates = {"no_native": DEMO_READS / off[2]["s"], "native": DEMO_READS / on[2]["s"]}
    log(f"  (f) XSPECT_NO_NATIVE [{card}]: {PRODUCT_PARITY_READS} reads on the card take K4 + K3 "
        f"({off[0]['launches']}), JSON equal "
        f"to the CPU's and to the native route's (K1 + K2, {on[0]['launches']}); {DEMO_READS} reads, second call: "
        f"records route {off[2]['s']:.2f} s, {rates['no_native']:.0f} reads/s (first {off[1]['s']:.2f} s); reads route "
        f"{on[2]['s']:.2f} s, {rates['native']:.0f} reads/s (first {on[1]['s']:.2f} s); three subprocesses "
        f"{wall:.1f} s")
    return launches, rates


def run_product(card: str):
    """Phase 10, the shipped product path on the card, (a)-(f); every step
    of (b)-(f) is held against the same step with ``--device cpu``.
    Returns (the launches of every step on the card, the seconds and
    rates logged)."""
    from xspect2_tpu_torch import model_cache

    base = WORK / "product"
    rng = np.random.default_rng(PRODUCT_SEED)
    saved_env = {k: os.environ.get(k) for k in ("XSPECT_DATA_ROOT", "XSPECT_NCBI_URL", "XSPECT_PUBMLST_URL")}
    model_cache.clear()
    blocked = []
    reset_launches()
    t0 = time.time()
    try:
        with loopback_only(blocked):
            demo, demo_times = run_demo(base, card)
            subset = run_card_and_cpu(base, demo, card)
            run_mlst_product(base, demo, rng, card)
            run_ncbi_product(base, card)
            run_pangenome_product(base, rng, card)
        launches = read_launches()
        f_launches, rates = run_no_native(base, demo, subset, card)
        add_launches(launches, f_launches)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        model_cache.clear()
    require(not blocked, f"the product phase tried to leave this machine: {blocked}")
    summary = dict(demo_times, **{f"{k}_reads_per_s": round(v, 1) for k, v in rates.items()}, phase_s=time.time() - t0)
    log(f"  product [{card}]: {json.dumps(summary)}; launches {json.dumps(launches)}; no connection left 127.0.0.1")
    shutil.rmtree(base, ignore_errors=True)
    return launches, summary



# ---------------------------------------------------------------- phase 11

# K9's timed shape: 2**21 indices of 512 B rows (the production block row)
# on a 200 MB table, the shape recalibrate_constants scans at
CALIBRATION_N = 1 << 21
CALIBRATION_TABLE_MB = 200
# the second gather scan of recalibrate_constants, across the 50 MB L2
FINE_SIZES_MB = "8,16,24,32,40,48,56,64,80,100,150,200,400"
# the index geometries the smoke drives (PERF.md section 4): (name, classes, bp a class)
SMOKE_GEOMETRIES = (
    ("species reads 8 x 4 Mbp", 8, 4_000_000),
    ("genus reads 1 x 32 Mbp", 1, 32_000_000),
    ("records species 40 x 4 Mbp", 40, 4_000_000),
    ("metagenome genus 1 x 160 Mbp", 1, 160_000_000),
    ("demo species 3 x 4 Mbp", 3, 4_000_000),
    ("pangenome species 3 x 0.3 Mbp", 3, 300_000),
)


def check_row_gather(card, errors, ptxas_log):
    """11a: K9 in its three modes equals its plain version at 512 B and 4 KB
    rows on the 200 MB table, the window clipping on both sides; at 512 B
    rows around the grid stride of its launch (one index, a stride less
    one, a stride, a stride and one, seven strides and 3, 2**21 less 3) on
    index views that start 0, 4, 8 and 12 B past a 16 B boundary, drawn
    from a generator of their own so that the timed indices stay the
    earlier runs'; then K9's launch (the constants of its source, this
    card's SMs, and each mode's registers from ``-Xptxas -v``,
    ``ptxas_log``, None for a library built before this run), and K9 at 2**21 indices of 512 B rows on a 200 MB
    table: time, the distinct-row bound (each distinct row once), the
    in-order floor (``in_order_floor_bytes``, uniformly random indices),
    plain time, and the library form (``index_select`` then ``sum``, which
    writes and reads back the whole gather)."""
    from xspect2_tpu_torch.ops.row_gather import (
        BLOCKS_AN_SM,
        L2_BYTES,
        MODES,
        THREADS_A_BLOCK,
        grid_stride,
        in_order_floor_bytes,
        lanes_a_row,
        row_gather,
        row_gather_plain,
    )
    from xspect2_tpu_torch.tools._synthetic import random_table

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def hold(t, idx, mode, window, label):
        got = row_gather(t, idx, mode, window)
        want = row_gather_plain(t, idx, mode, window)
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        errors["row_gather"] = max(errors["row_gather"], err)
        log(f"  row_gather vs plain: {label}, {mode}{'' if window is None else f' {window}'}: max |err| {err}")

    for row_bytes, n in ((512, CALIBRATION_N), (4096, CALIBRATION_N // 8)):
        rows = int(CALIBRATION_TABLE_MB * 1e6 / row_bytes)
        table = random_table(rng, rows, row_bytes // 4, dev)
        idx = torch.from_numpy(rng.integers(0, rows, size=n, dtype=np.int32)).to(dev)
        lo, hi = rows // 3, rows // 3 + rows // 4
        for mode, window, t in (("total", None, table), ("per_row", None, table),
                                ("window", (lo, hi - lo), table[lo:hi])):
            hold(t, idx, mode, window, f"{row_bytes} B rows, {rows} rows, n={n}")
        if row_bytes == 512:
            step = grid_stride(128, sms)
            edge_rng = np.random.default_rng(11)
            pool = torch.from_numpy(edge_rng.integers(-5, rows + 5, size=n, dtype=np.int32)).to(dev)
            for shift in range(4):
                for n_edge in (1, step - 1, step, step + 1, 7 * step + 3, n - 3):
                    view = pool[shift:shift + n_edge]
                    for mode, window, t in (("total", None, table), ("per_row", None, table),
                                            ("window", (lo, hi - lo), table[lo:hi])):
                        hold(t, view, mode, window, f"512 B rows, idx {4 * shift} B past 16 B, n={n_edge}")
            del pool
        del table, idx
    require(errors["row_gather"] == 0, "row_gather disagrees with its plain version")
    registers = {}
    fn = None
    for line in ptxas_log.splitlines():
        m = re.search(r"row_gather_kernelILi(\d)E", line)
        if m:
            fn = int(m.group(1))
        elif fn is not None and "registers" in line:
            registers[fn] = int(re.search(r"Used (\d+) registers", line).group(1))
    launch = {"warps_a_block": THREADS_A_BLOCK // 32, "blocks_an_sm": BLOCKS_AN_SM, "sms": sms,
              "dynamic_smem_bytes": 0, "lanes_a_row": lanes_a_row(128), "grid_stride": grid_stride(128, sms),
              "registers": {mode: registers.get(code) for mode, code in MODES.items()}}
    log(f"  row_gather launch [{card}], 512 B rows: {launch['warps_a_block']} warps a block, at most "
        f"{BLOCKS_AN_SM} blocks an SM of {sms}, no dynamic shared memory, {launch['lanes_a_row']} lanes a row, "
        f"a grid stride of {launch['grid_stride']} indices, registers {launch['registers']}")

    n = CALIBRATION_N
    rows = int(CALIBRATION_TABLE_MB * 1e6 / 512)
    table = random_table(rng, rows, 128, dev)
    idx = torch.from_numpy(rng.integers(0, rows, size=n, dtype=np.int32)).to(dev)
    k9 = timed(lambda: row_gather(table, idx), 20)
    plain = cuda_ms(lambda: row_gather_plain(table, idx), 2)
    library = cuda_ms(lambda: table.index_select(0, idx).sum(), 5)
    # each row that the indices name read once, each index once, the sum
    # written once; a row named again may come from the L2
    touched = int(torch.unique(idx).numel())
    nbytes = touched * 512 + 4 * n + 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    every_ms = (n * 512 + 4 * n) / HBM_BYTES_PER_S * 1e3
    floor_ms = in_order_floor_bytes(n, 512, rows * 512, touched) / HBM_BYTES_PER_S * 1e3
    ops_ms = n * 128 / INT_OPS_PER_S * 1e3  # one add a word
    dev_ms = k9["device_ms"] or k9["ms"]
    log(f"  timing [{card}] row_gather ({n} indices of 512 B rows, a {CALIBRATION_TABLE_MB} MB table): {ms_text(k9)}, "
        f"bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}: {touched} distinct rows of {rows} and the "
        f"indices, {nbytes} B once; operations {ops_ms:.4f}; every gathered row from memory, n x 512 B + 4n, "
        f"{every_ms:.4f}), in_order_floor_ms {floor_ms:.4f} (the L2 holding {L2_BYTES / 1e6:g} MB of the table; "
        f"the kernel's device-only time {dev_ms / floor_ms:.3f}x it), plain {plain:.4f} ms, index_select + sum {library:.4f} ms")
    return dict(k9, plain_ms=plain, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=library,
                in_order_floor_ms=floor_ms, launch=launch)


def picker_part(card, budgets, genomes, reads, species_idx, launches):
    """11f: ``pick_num_hashes`` under the card's budgets for every geometry
    the smoke drives, beside the shipped choice; the phase-3 genomes fitted
    once more under the scan's budget, and K2 device-only at the picked h
    beside the shipped h on the same reads, both held against the host."""
    from xspect2_tpu_torch import native
    from xspect2_tpu_torch.core.blocked_index import FAST_TABLE_BYTES, BlockedBitSlicedIndex, pick_num_hashes
    from xspect2_tpu_torch.models.filter_model import _READS_PER_CHUNK
    from xspect2_tpu_torch.ops import query

    budgets = {"shipped": FAST_TABLE_BYTES, **budgets}
    for name, classes, bp in SMOKE_GEOMETRIES:
        picks = {b: pick_num_hashes(bp - K + 1, 0.01, classes, budget_bytes=v) for b, v in budgets.items()}
        log(f"  pick_num_hashes [{card}] {name}: " + ", ".join(f"{b} budget {budgets[b]} B -> h={h}"
                                                              for b, h in picks.items()))
    budget = budgets["scan across the L2"]
    h = pick_num_hashes(GENOME_LEN - K + 1, 0.01, 8, budget_bytes=budget)
    t0 = time.time()
    idx = BlockedBitSlicedIndex.create(K, species_idx.class_names, GENOME_LEN - K + 1, fpr=0.01, num_hashes=h)
    for ci in range(idx.num_classes):
        native.insert_kmers(idx, ci, genomes[ci])
    log(f"  the species genomes fitted under the budget {budget} B: h={h} P={idx.fields_per_word}, "
        f"{idx.nbytes / 1e6:.1f} MB ({time.time() - t0:.1f} s); shipped h={species_idx.num_hashes}, "
        f"{species_idx.nbytes / 1e6:.1f} MB")
    if h == species_idx.num_hashes:
        require(np.array_equal(idx.table, species_idx.table), "the same probe count fitted another table")
    sample = np.random.default_rng(11).choice(len(reads), size=SAMPLE, replace=False)
    reset_launches()
    times = {}
    for label, ix in ((f"shipped h={species_idx.num_hashes}", species_idx), (f"picked h={h}", idx)):
        engine = query.DeviceQueryEngine(ix, device="cuda")
        codes = query.unpack_2bit(*engine.upload_wire(reads, _READS_PER_CHUNK), READ_LEN)
        geom = dict(step=1, **engine.geometry())
        out = query.reads_query(codes, engine.table, **geom)
        require(np.array_equal(out[sample].cpu().numpy().astype(np.int64), host_counts(ix, reads[sample])),
                f"K2 at the {label} index differs from the host reference")
        dev, by = device_ms(lambda: query.reads_query(codes, engine.table, **geom), 10)
        times[label] = dev
        log(f"  timing [{card}] reads_query at the {label} index ({ix.nbytes / 1e6:.1f} MB), {len(reads)} reads: "
            f"{dev:.4f} ms device-only ({by}); {SAMPLE} sampled reads equal the host reference")
        del engine, codes, out
    got = read_launches()
    add_launches(launches, got)
    require(got["unpack_2bit"] > 0 and got["reads_query"] > 0, "the picker's A/B did not launch K1 and K2")
    return times


def run_calibration(card, genomes, reads, species_idx):
    """11b-11f: the port's recalibrate_constants twice (its defaults, and a
    scan across the L2), the gather grid, sorted gather and split at their
    defaults, the block-shard tool on the 40-class geometry, the fields
    tool, and what the card's budget would pick.  Each part's launches are
    read after it and must include its kernels.  Returns (the launches,
    the constants and rates logged)."""
    from xspect2_tpu_torch.tools import (
        microbench_blockshard,
        microbench_fields,
        microbench_gather,
        microbench_sorted_gather,
        microbench_split,
        recalibrate_constants,
    )

    launches = {name: 0 for name in KERNELS}
    seconds = {}

    def part(label, fn, kernels):
        reset_launches()
        t0 = time.time()
        out = fn()
        got = read_launches()
        seconds[label] = round(time.time() - t0, 2)
        add_launches(launches, got)
        log(f"  {label} [{card}]: {seconds[label]:.1f} s, launches {json.dumps({k: v for k, v in got.items() if v})}")
        require(all(got[k] > 0 for k in kernels), f"{label} did not launch {kernels}: {got}")
        return out

    engine_kernels = ("row_gather", "unpack_2bit", "reads_query")
    consts = {}
    for label, sizes in (("defaults", None), ("scan across the L2", FINE_SIZES_MB)):
        kwargs = {} if sizes is None else {"sizes_mb": [float(s) for s in sizes.split(",")]}
        res = part(f"recalibrate_constants ({label})", lambda: recalibrate_constants.run(**kwargs), engine_kernels)
        consts[label] = {k: res[k] for k in ("body_ns", "fast_ns", "slow_ns", "budget_bytes", "t2", "t7", "cliff")}
        log(f"  constants [{card}] ({label}, the sizes {sizes or 'of the tool'}): {json.dumps(consts[label])}; "
            f"rates M rows/s {json.dumps({f'{mb:g}': round(r / 1e6, 1) for mb, r in res['rates'].items()})}; "
            f"engine A/B {json.dumps({h: [round(v, 1) for v in ab] for h, ab in res['ab'].items()})}")
        log("  the printed block (" + label + "):" + res["block"].replace("\n", "\n    "))
    part("microbench_gather", microbench_gather.run, ("row_gather",))
    sorted_res = part("microbench_sorted_gather", microbench_sorted_gather.run, ("row_gather",))
    require(all(len(set(r["checksums"])) == 1 for r in sorted_res["rows"]),
            "random, sorted and pipelined gathers disagree")
    part("microbench_split", microbench_split.run, ("row_gather",))
    shard = part("microbench_blockshard", microbench_blockshard.run, ("reads_query",))
    require(all(shard["tiles_equal"].values()),
            f"the block shards' owned-block counts do not sum to the whole table's: {shard['tiles_equal']}")
    log(f"  block shards: the owned-block counts of the n_blk windows sum to the whole table's exactly "
        f"({shard['num_blocks']} blocks, {shard['nbytes'] / 1e6:.1f} MB)")
    part("microbench_fields", microbench_fields.run, ("reads_query", "row_gather"))
    t0 = time.time()
    k2_times = picker_part(card, {k: v["budget_bytes"] for k, v in consts.items()}, genomes, reads, species_idx,
                           launches)
    seconds["picker"] = round(time.time() - t0, 2)
    summary = dict(constants=consts, k2_device_ms=k2_times, seconds=seconds)
    log(f"  calibration [{card}]: {json.dumps(summary)}")
    return launches, summary



# ---------------------------------------------------------------- phase 12

# K10's checks: every variant at three class counts (1, 2 and 4 class
# words) and three probe counts, on reads that end in a partial chunk;
# (read length, k, reads, reads a chunk): the timed read length, then a
# single short group of 32 windows (40 bp), one full group (52 bp), a full
# group and one window (53 bp), and k = 31, on a read count that is no
# multiple of K10's warps a block (6-8)
BODY_CHECK_CLASSES = (8, 40, 128)
BODY_CHECK_HASHES = (1, 3, 7)
BODY_CHECK_SHAPES = ((150, 21, 3_000, 1_024), (40, 21, 1_003, 256), (52, 21, 1_003, 256), (53, 21, 1_003, 256),
                     (150, 31, 1_003, 256))
BODY_CHECK_TABLE_MB = 4
# microbench_body's table at its default and at the species headline's size
BODY_TABLE_MB = (50.0, 100.0)
# microbench_spmd: calls a timed window (about a second of the single
# engine's 32,768 reads) and windows, the single engine and each mesh in turn
SPMD_ITERS = 100
SPMD_REPEATS = 5


def body_ops(variant: str, num_hashes: int, num_classes: int, class_words: int) -> int:
    """Estimated integer operations a k-mer of a K10 variant needs, counted
    from the function and not from a formulation: the pack and hash
    (WINDOW_OPS), h for the row mask, then 3 a block word for the AND of
    the selected rows (bit test, select, AND, as K8's bound counts a
    word), and 2 a class to count (the counting variants) or an add a
    class word (noplanes, cwm_noplanes); gatheronly adds each block word
    and each of the h row ids (2 each with the row's address)."""
    from xspect2_tpu_torch.ops.body_variants import BLOCK_WORDS, COUNTING

    if variant == "gatheronly":
        return WINDOW_OPS + BLOCK_WORDS + 2 * num_hashes
    count = 2 * num_classes if variant in COUNTING else class_words
    return WINDOW_OPS + num_hashes + 3 * BLOCK_WORDS + count


def check_body_variants(card, errors):
    """12a: K10 against its plain version, each variant at C = 8, 40 and 128
    and h = 1, 3 and 7, at each of BODY_CHECK_SHAPES (the last chunk
    partial), once as drawn and once with N codes (which pack as 0 and
    count); the counting variants against K2 on the same row-major table
    and clean reads.  All exact."""
    from xspect2_tpu_torch.ops import body_variants as bv
    from xspect2_tpu_torch.ops import query
    from xspect2_tpu_torch.tools._synthetic import random_table

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    k2_err = 0
    for num_classes in BODY_CHECK_CLASSES:
        class_words, rows_per_block = bv.geometry(num_classes)
        num_blocks = int(BODY_CHECK_TABLE_MB * 1e6 / (4 * bv.BLOCK_WORDS))
        table = random_table(rng, num_blocks, bv.BLOCK_WORDS, dev)
        cwm = bv.class_word_major(table, num_classes)
        for read_len, k, n_reads, chunk in BODY_CHECK_SHAPES:
            reads = torch.from_numpy(rng.integers(0, 4, size=(n_reads, read_len), dtype=np.uint8)).to(dev)
            with_n = reads.clone()
            rows = torch.from_numpy(rng.integers(0, n_reads, n_reads // 10)).to(dev)
            with_n[rows, torch.from_numpy(rng.integers(0, read_len, n_reads // 10)).to(dev)] = 255
            for h in BODY_CHECK_HASHES:
                k2 = query.reads_query(reads, table, k=k, step=1, num_blocks=num_blocks,
                                       rows_per_block=rows_per_block, class_words=class_words, num_hashes=h,
                                       fields_per_word=1, num_classes=num_classes).int()
                errs = {}
                for v in bv.VARIANTS:
                    t = cwm if v in bv.CLASS_WORD_MAJOR else table
                    kw = dict(num_classes=num_classes, num_hashes=h, reads_per_chunk=chunk, k=k)
                    err = 0
                    for r in (reads, with_n):
                        got = bv.body_variants(v, r, t, **kw)
                        want = bv.body_variants_plain(v, r, t, **kw)
                        err = max(err, int((got.long() - want.long()).abs().max()))
                        if v in bv.COUNTING and r is reads:
                            k2_err = max(k2_err, int((got - k2).abs().max()))
                    errs[v] = err
                    errors["body_variants"] = max(errors["body_variants"], err)
                log(f"  body_variants vs plain: C={num_classes} (cw={class_words}, rpb={rows_per_block}) h={h}, "
                    f"{n_reads} reads of {read_len} bp at k={k} in chunks of {chunk}, with and without N: max "
                    f"|err| {json.dumps(errs)}; counting variants vs reads_query max |err| {k2_err}, hits "
                    f"{int(k2.sum())}")
    require(errors["body_variants"] == 0, "body_variants disagrees with its plain version")
    require(k2_err == 0, "a counting body variant disagrees with reads_query")


def k10_build(read_len: int, num_classes: int, ptxas_log: str) -> dict:
    """K10's launch at ``read_len`` and ``num_classes`` on this card, by
    variant, as the kernel library reports it after the timed launches
    (``launch_config``: warps a block, one block an SM, dynamic shared
    memory, registers), and what ``-Xptxas -v`` said (``ptxas_log``) of the
    instantiations at that class-word count."""
    from xspect2_tpu_torch.ops.body_variants import VARIANTS, geometry, launch_config

    out = {"launch": {v: launch_config(v, read_len, num_classes) for v in VARIANTS}, "ptxas": {}}
    cw = geometry(num_classes)[0]
    fn = None
    for line in ptxas_log.splitlines():
        m = re.search(r"body_kernelILi(\d)ELi(\d+)E", line)
        if m:
            fn = VARIANTS[int(m.group(1))] if int(m.group(2)) == cw else None
        elif fn and ("registers" in line or "spill" in line):
            out["ptxas"][fn] = "; ".join(filter(None, [out["ptxas"].get(fn), line.split("info    :")[-1].strip()]))
    return out


def time_body_variants(card, table_mb, res, errors, ptxas_log):
    """K10 at microbench_body's inputs (``table_mb``, 8 classes, h = 7,
    65,536 reads): each variant's call and device-only ms, bound, the rate
    of every block read from memory, and its device-only time as a
    multiple of K2's, gatheronly's and its bound; K2 on the same row-major
    table and reads (its counts equal ``current``'s); each plain version,
    timed once on the same inputs and held against the tool's output of
    that variant (exact); at the default table also ``gatheronly``'s
    library form, ``index_select`` of the blocks then ``sum``, and the
    registers (from ``ptxas_log``, K10's compiler output) and shared
    memory of the timed instantiations."""
    from xspect2_tpu_torch.core.hashing import block_words_fieldbase_torch
    from xspect2_tpu_torch.ops import body_variants as bv
    from xspect2_tpu_torch.ops import query
    from xspect2_tpu_torch.tools import microbench_body

    num_classes, h, rpc = 8, 7, 8192
    class_words, rows_per_block = bv.geometry(num_classes)
    table, cwm, codes = microbench_body.inputs(table_mb, num_classes, 65_536, "cuda")
    n = codes.shape[0]
    nk = READ_LEN - K + 1
    geom = dict(k=K, step=1, num_blocks=table.shape[0], rows_per_block=rows_per_block, class_words=class_words,
                num_hashes=h, fields_per_word=1, num_classes=num_classes)
    k2_out = query.reads_query(codes, table, **geom)
    require(np.array_equal(k2_out.int().cpu().numpy(), res["outs"]["current"]),
            f"reads_query differs from the body variants on microbench_body's {table_mb} MB inputs")
    k2 = timed(lambda: query.reads_query(codes, table, **geom), 10)
    k2_b = reads_bound(SimpleNamespace(num_blocks=table.shape[0], rows_per_block=rows_per_block,
                                       class_words=class_words, num_hashes=h, fields_per_word=1), codes, k2_out)
    hi, lo, _ = query._canonical_windows_plain(codes.long(), K, nk)
    block, _, _ = block_words_fieldbase_torch(hi.reshape(-1), lo.reshape(-1), table.shape[0], rows_per_block, h)
    del hi, lo
    distinct = int(torch.unique(block).numel())
    every_ms = block.numel() * 512 / HBM_BYTES_PER_S * 1e3
    # K2 reads a k-mer's probe sectors, K10 its whole block: both as rates
    k2_dev = k2["device_ms"] or k2["ms"]
    sector_tb_s = k2_b["window_sectors"] * SECTOR_BYTES / (k2_dev * 1e-3) / 1e12
    log(f"  timing [{card}] reads_query on microbench_body's {table_mb:g} MB table ({table.shape[0]} blocks), {n} "
        f"reads: {ms_text(k2)}, bound {max(k2_b['bytes_ms'], k2_b['ops_ms']):.4f} ms; its {k2_b['window_sectors']} "
        f"probe sectors of 32 B at {sector_tb_s:.3f} TB/s; {distinct} distinct blocks of {block.numel()} k-mers; "
        f"every k-mer's 512 B block from memory {every_ms:.4f} ms")
    out = {"k2": dict(k2, bound_ms=max(k2_b["bytes_ms"], k2_b["ops_ms"]), probe_sectors=k2_b["window_sectors"],
                      sector_tb_s=sector_tb_s), "distinct_blocks": distinct, "every_block_ms": every_ms}
    for v in bv.VARIANTS:
        t = cwm if v in bv.CLASS_WORD_MAJOR else table
        kw = dict(num_classes=num_classes, num_hashes=h, reads_per_chunk=rpc)
        k10 = timed(lambda: bv.body_variants(v, codes, t, **kw), 10)
        nbytes = distinct * 512 + codes.numel() + n * num_classes * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = block.numel() * body_ops(v, h, num_classes, class_words) / INT_OPS_PER_S * 1e3
        row = dict(k10, bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   tool=res["variants"][v])
        # the plain version on the same inputs, timed once, against the
        # tool's own output of this variant
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = bv.body_variants_plain(v, codes, t, **kw)
        end.record()
        end.synchronize()
        row["plain_ms"] = start.elapsed_time(end)
        got = torch.from_numpy(res["outs"][v])
        require(got.shape == want.shape, f"body_variants {v}: shape {tuple(got.shape)}, plain {tuple(want.shape)}")
        row["max_abs_err"] = int((got.long() - want.cpu().long()).abs().max())
        errors["body_variants"] = max(errors["body_variants"], row["max_abs_err"])
        del want, got
        extra = f", plain {row['plain_ms']:.4f} ms, max |err| vs plain {row['max_abs_err']}"
        if table_mb == BODY_TABLE_MB[0] and v == "gatheronly":
            row["library_ms"] = cuda_ms(lambda: table.index_select(0, block).sum(), 3)
            extra += f", index_select + sum {row['library_ms']:.4f} ms"
        dev = k10["device_ms"] or k10["ms"]
        log(f"  timing [{card}] body_variants {v} ({table_mb:g} MB, {n} reads, h={h}): tool "
            f"{res['variants'][v]['reads_per_s']:,.0f} reads/s, {res['variants'][v]['device_ms']:.4f} ms between "
            f"events; {ms_text(k10)}, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: bytes {bytes_ms:.4f}, "
            f"operations {ops_ms:.4f}), {dev / row['bound_ms']:.1f}x it{extra}; {dev / every_ms:.2f}x every block "
            f"from memory, "
            f"{dev / k2_dev:.2f}x reads_query")
        out[v] = row
    # each variant's device-only time as a multiple of K2's, gatheronly's
    # and its bound, all of this run
    gather_dev = out["gatheronly"]["device_ms"] or out["gatheronly"]["ms"]
    for v in bv.VARIANTS:
        dev = out[v]["device_ms"] or out[v]["ms"]
        out[v].update(x_reads_query=dev / k2_dev, x_gatheronly=dev / gather_dev, x_bound=dev / out[v]["bound_ms"])
    log(f"  timing [{card}] body_variants ({table_mb:g} MB) device-only ms, and as multiples of reads_query "
        f"({k2_dev:.4f} ms), gatheronly ({gather_dev:.4f} ms) and the bound: "
        + json.dumps({v: [round(out[v]["device_ms"] or out[v]["ms"], 4), round(out[v]["x_reads_query"], 3),
                          round(out[v]["x_gatheronly"], 3), round(out[v]["x_bound"], 1)] for v in bv.VARIANTS}))
    if table_mb == BODY_TABLE_MB[0]:
        out["build"] = k10_build(READ_LEN, num_classes, ptxas_log)
        log(f"  body_variants build [{card}] at {READ_LEN} bp: {json.dumps(out['build'])}")
    require(errors["body_variants"] == 0,
            f"body_variants disagrees with its plain version on microbench_body's {table_mb:g} MB inputs")
    return out


def run_body_tools(card, errors, ptxas_log):
    """12b-12c: microbench_body at its defaults and at a 100 MB table, each
    variant timed beside K2 (``ptxas_log``: K10's compiler output);
    microbench_spmd at its defaults.  The tools'
    launches are read after each run and must include their kernels.
    Returns (the launches, K10's timings, the numbers logged)."""
    from xspect2_tpu_torch.tools import microbench_body, microbench_spmd

    launches = {name: 0 for name in KERNELS}
    timings, seconds = {}, {}
    for table_mb in BODY_TABLE_MB:
        reset_launches()
        t0 = time.time()
        res = microbench_body.run(table_mb=table_mb)
        got = read_launches()
        seconds[f"microbench_body {table_mb:g} MB"] = round(time.time() - t0, 2)
        add_launches(launches, got)
        require(got["body_variants"] > 0, f"microbench_body did not launch body_variants: {got}")
        require(all(res["equal"].values()), f"microbench_body's counting variants disagree: {res['equal']}")
        log(f"  microbench_body [{card}] ({table_mb:g} MB, {res['num_blocks']} blocks): "
            f"{seconds[f'microbench_body {table_mb:g} MB']:.1f} s, launches "
            f"{json.dumps({k: v for k, v in got.items() if v})}; counting variants equal: {json.dumps(res['equal'])}")
        timings[f"{table_mb:g}MB"] = time_body_variants(card, table_mb, res, errors, ptxas_log)
        del res
    reset_launches()
    t0 = time.time()
    spmd = microbench_spmd.run(iters=SPMD_ITERS, repeats=SPMD_REPEATS)
    got = read_launches()
    seconds["microbench_spmd"] = round(time.time() - t0, 2)
    add_launches(launches, got)
    require(got["unpack_2bit"] > 0 and got["reads_query"] > 0, f"microbench_spmd did not launch K1 and K2: {got}")
    mesh = {k: dict(reads_per_s=v["reads_per_s"], overhead_pct=v["overhead_pct"],
                    overhead_pct_range=v["overhead_pct_range"]) for k, v in spmd["meshes"].items()}
    single_range = spmd["single_reads_per_s_range"]
    log(f"  microbench_spmd [{card}]: {SPMD_REPEATS} windows of {SPMD_ITERS} calls each, single engine and meshes in "
        f"turn; single engine median {spmd['single_reads_per_s']:,.0f} reads/s (windows {single_range[0]:,.0f} to "
        f"{single_range[1]:,.0f}); meshes (median, and the range of the windows' overheads) {json.dumps(mesh)}; every "
        f"mesh's counts equal the single engine's ({spmd['single'].shape[0]} reads, hits {int(spmd['single'].sum())}); "
        f"launches {json.dumps({k: v for k, v in got.items() if v})}")
    summary = dict(spmd_single_reads_per_s=spmd["single_reads_per_s"], spmd_single_reads_per_s_range=single_range,
                   spmd_meshes=mesh, spmd_iters=SPMD_ITERS, spmd_repeats=SPMD_REPEATS, seconds=seconds)
    return launches, timings, summary



# ---------------------------------------------------------------- main


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args()
    card_id = pin_one_card()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import xspect2_tpu_torch  # noqa: F401 - fails outside a checkout

    card = card_line(card_id)
    log(f"card: {card}")
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    os.environ["XSPECT_DATA_ROOT"] = str(WORK / "xspect-data")
    rng = np.random.default_rng(args.seed)
    t_start = time.time()

    log("phase 1: build")
    build_logs = build_all()
    errors = {name: 0 for name in KERNELS}
    log("phase 2: kernels against their plain versions")
    check_kernels(rng, errors)
    check_records_kernels(rng, errors)
    check_multi_kernels(rng, errors)
    check_sharded_kernels(rng, errors)
    check_svm_head_kernel(errors)

    log("phase 3: species reads, 8 classes x 4 Mbp")
    genomes = rng.integers(0, 4, size=(8, 4_000_000), dtype=np.uint8)
    species_idx = build_index([f"{1000 + i}" for i in range(8)], genomes)
    require(
        (species_idx.num_hashes, species_idx.fields_per_word) == (2, 4),
        "species geometry is not the headline h=2, P=4",
    )
    sp_launches, sp_reads, sp_counts, sp_src = run_path("species", species_idx, genomes, rng, card)
    log("phase 3a: the read benchmark pipeline on the species reads, under the profiler")
    rb_launches, rb_busy = run_read_benchmark_traced(species_idx, sp_reads, sp_src, sp_counts, card)
    del sp_counts, sp_src
    timings = time_kernels(species_idx, sp_reads, card, errors)
    log("phase 3b: species reads on (data x blk) meshes, every shard in turn on this card")
    k2_sharded = run_sharded_reads("species", species_idx, sp_reads, card, errors)

    log("phase 4: genus reads and genus assemblies, 1 class x 32 Mbp")
    genus_genome = rng.integers(0, 4, size=(1, 32_000_000), dtype=np.uint8)
    genus_idx = build_index(["smoke"], genus_genome)
    ge_launches, ge_reads, _, _ = run_path("genus", genus_idx, genus_genome, rng, card)
    ge_timings = time_kernels(genus_idx, ge_reads, card, errors)
    log("phase 4b: genus reads on (data x blk) meshes, every shard in turn on this card")
    run_sharded_reads("genus", genus_idx, ge_reads, card, errors)
    del ge_reads
    ga_launches, genus_assemblies = run_genus_assemblies(genus_genome, genus_idx, rng, card)
    del genus_idx

    log("phase 5: SVM species head on reads")
    check_svm(species_idx, genomes, rng)

    log("phase 6: records, 40-class x 4 Mbp SVM species model and the 160 Mbp metagenome genus model through "
        "train_from_directory, then 20 assemblies at steps 1 and 4")
    rec_launches, rec_timings, asm = run_records(rng, card, errors)
    log("phase 6b: the 40-class table on (data x cls) and (data x blk) meshes, every shard in turn on this card")
    k3_sharded, head_timing = run_sharded_records(asm, card, errors, build_logs["svm_head"])
    log("phase 6c: both sharded classifiers through their public methods, NCCL at world size 1")
    nccl_launches, k2_nccl = run_nccl_world_of_one(asm, card)
    log(f"phase 6d: validation, {VAL_MAJORITY + VAL_CLUSTERED + VAL_SPREAD} reads through classify_species("
        f"validation=True) on the 40-class model, each class's genome seeded as its reference")
    val_launches, val_timings, val_e2e = run_validation(asm, card, errors)
    del asm

    log(f"phase 7: MLST, {MLST_LOCI} loci x {MLST_ALLELES} alleles x {ALLELE_LEN} bp, {MLST_GENOMES} genomes of "
        f"{GENOME_LEN} bp (depth cut: the genome count) and {MLST_SHORT} short records")
    mlst_launches, mlst_timings = run_mlst(rng, card, errors)

    log(f"phase 8: xxh3 compat genus model over the 32 Mbp genus genome, {XXH3_ASSEMBLIES} assemblies "
        f"and {XXH3_READS} reads")
    x_launches, x_timings = run_xxh3_genus(genus_genome, genus_assemblies, rng, card, errors)
    del genus_genome, genus_assemblies

    log("phase 9: the probe-select microbenchmark at its default shape")
    p_launches, p_timings, k2_microbench = run_microbench(card, errors)

    log(f"phase 10: the shipped product path: the demo (tools/demo_e2e.py, {DEMO_GENOME_MB} Mbp genomes, {DEMO_READS} "
        f"reads), the CLI's all, filter, train mlst and train ncbi, the pangenome training and the grid search, and "
        f"XSPECT_NO_NATIVE, each against the same step on the CPU")
    product_launches, product = run_product(card)

    log("phase 11: the card's memory regimes and the picker's constants: K9 against its plain version, "
        "recalibrate_constants at its defaults and across the L2, the gather grid, sorted gather, split, "
        "block shards (40 x 4 Mbp), fields, and what the card's budget would pick")
    t11 = time.time()
    k9_timing = check_row_gather(card, errors, build_logs["row_gather"])
    cal_launches, calibration = run_calibration(card, genomes, sp_reads, species_idx)
    log(f"phase 11 [{card}]: {time.time() - t11:.1f} s")
    del genomes, species_idx, sp_reads

    log("phase 12: the read query's body formulations and the mesh overhead: K10 against its plain version and "
        "K2, microbench_body at 50 and 100 MB beside K2, microbench_spmd (4x2 and 8x1 meshes, every coordinate "
        "in turn on this card)")
    t12 = time.time()
    check_body_variants(card, errors)
    body_launches, body_timings, body_summary = run_body_tools(card, errors, build_logs["body_variants"])
    log(f"phase 12 [{card}]: {time.time() - t12:.1f} s")

    default_body = body_timings[f"{BODY_TABLE_MB[0]:g}MB"]
    k10_timing = dict({k: v for k, v in default_body["current"].items() if k not in ("tool", "max_abs_err")},
                      library_ms=None,
                      variants=body_timings)
    all_timings = {**rec_timings, **timings, **mlst_timings, **x_timings, **p_timings, "row_gather": k9_timing,
                   "body_variants": k10_timing,
                   "svm_head": {k: v for k, v in head_timing.items() if k != "near_zero"}}
    all_timings["reads_query"]["block_sharded"] = k2_sharded
    # K2 over its launches of the run at their own shapes (species, genus,
    # the NCCL runs, the microbenchmark): time less bound, summed
    k2_shapes = [
        (sp_launches["reads_query"], timings["reads_query"]["ms"], timings["reads_query"]["bound_ms"]),
        (ge_launches["reads_query"], ge_timings["reads_query"]["ms"], ge_timings["reads_query"]["bound_ms"]),
        (nccl_launches["reads_query"], *k2_nccl), (p_launches["reads_query"], *k2_microbench),
    ]
    all_timings["reads_query"]["run_gap_ms"] = sum(n * (ms - bound) for n, ms, bound in k2_shapes)
    log(f"run gaps [{card}]: reads_query {all_timings['reads_query']['run_gap_ms']:.4f} ms over "
        f"{sum(n for n, _, _ in k2_shapes)} launches at their own shapes, xxh3_records_count "
        f"{x_timings['xxh3_records_count']['run_gap_ms']:.4f} ms over {x_launches['xxh3_records_count']}, bloom_count "
        f"{x_timings['bloom_count']['run_gap_ms']:.4f} ms over {x_launches['bloom_count']} (time less bound, summed)")
    all_timings["records_query"]["block_sharded"] = k3_sharded
    for name in ("records_wire", "records_query"):
        all_timings[name]["validation"] = val_timings[name]
    all_launches = (sp_launches, rb_launches, ge_launches, ga_launches, rec_launches, nccl_launches, val_launches,
                    mlst_launches, x_launches, p_launches, product_launches, cal_launches, body_launches)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(run[name] for run in all_launches),
            "max_abs_err": errors[name], "library_ms": None, **all_timings[name],
        })
    from xspect2_tpu_torch.models.svm_head import SVMHead

    log(f"svm head [{card}]: {json.dumps(dict(head_timing, calls=SVMHead.calls))} (calls: every prediction of the run)")
    log(f"validation [{card}]: {json.dumps(val_e2e)}")
    log(f"product [{card}]: {json.dumps(product)}")
    log(f"calibration [{card}]: {json.dumps(calibration)}")
    log(f"body tools [{card}]: {json.dumps(body_summary)}")
    log(f"device busy share [{card}]: {rb_busy['busy_share']:.6f} over the traced read benchmark "
        f"({rb_busy['window_ms']:.3f} ms window, {rb_busy['kernel_busy_ms']:.3f} ms in kernels)")
    log(
        f"kernels [{card}]: launches summed over every main-path run (species and genus reads, the read "
        f"benchmark, "
        f"genus assemblies, the 40-class fit with the metagenome genus assemblies, both assembly runs, the "
        f"assembly benchmark and the web app's task, "
        f"the sharded classifiers' public methods at NCCL world size 1, the validated and the plain run "
        f"of the validation reads, classify_mlst and the three MLST predict runs, the xxh3 genus "
        f"assemblies and reads with the filter's count API, the microbenchmark, the product path's card steps, "
        f"the calibration and body tools); "
        f"unpack_2bit and reads_query "
        f"timed at the species reads shape, "
        f"records_wire and records_query at one 4 Mbp assembly (block_sharded: one of 4 block shards "
        f"at the same shapes; classes_512: a 512-class table, also on short records and the global-atomic "
        f"path; validation: the first batch of the validated reads), multi_records_query and reduce_record_counts at one group of 4 genomes, "
        f"xxh3_records_count at one 4 Mbp assembly, bloom_count at its longest contig, probe_select at one "
        f"chunk of 8,192 reads, row_gather at {CALIBRATION_N} indices of 512 B rows on a {CALIBRATION_TABLE_MB} MB "
        f"table, body_variants (current; every variant under variants) at microbench_body's 65,536 reads on a "
        f"{BODY_TABLE_MB[0]:g} MB table, svm_head at the main path's head on one row of 40 scores in the form "
        f"its plan picks (forms: each form forced; its launches: one a prediction on the card); "
        f"whole run {time.time() - t_start:.1f} s"
    )
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
