#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels and the native host library from the
sources in the checkout, checks each kernel against its plain PyTorch
version on the card, then drives the port's two paths end to end at
full width:

- reads: simulated FASTQ runs through ``xspect2_tpu_torch.classify``,
  an 8-class species model over 4 Mbp genomes and a 1-class genus model
  over 32 Mbp, 400,000 150 bp reads each (kernels K1 and K2);
- records: a 40-class x 4 Mbp SVM species model trained through
  ``ProbabilisticFilterSVMModel.fit``, then ``classify_species`` on 20
  held-out draft assemblies (4 Mbp, 20-400 contigs) at steps 1 and 4,
  and ``classify_genus`` on assemblies of the genus genome (K1, K4, K3).

It checks the results against the host reference, checks which kernels
each path launched, times each kernel against its bound and its plain
version, and prints one JSON line per the contract below as its last
line:

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

It uses one card, the first visible one.  It exits non-zero, printing
no result, when CUDA is absent, when the port cannot be imported, or
when any phase fails.  Everything it writes goes to
``build/chip_smoke/`` (``build/`` is ignored by git).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

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
# kernel name -> (source, the TPU program it replaces)
KERNELS = {
    "unpack_2bit": ("xspect2_tpu_torch/csrc/unpack_2bit.cu", "xspect2_tpu/ops/query.py:751"),
    "reads_query": ("xspect2_tpu_torch/csrc/reads_query.cu", "xspect2_tpu/ops/query.py:624"),
    "records_wire": ("xspect2_tpu_torch/csrc/records_wire.cu", "xspect2_tpu/ops/query.py:301"),
    "records_query": ("xspect2_tpu_torch/csrc/records_query.cu", "xspect2_tpu/ops/query.py:470"),
}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, the granule of a
# random HBM read, and the 32-bit non-tensor rate, above which the
# integer work of these kernels cannot run
HBM_BYTES_PER_S = 3.35e12
SECTOR_BYTES = 32
INT_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, after one warm-up."""
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


def reset_launches() -> None:
    from xspect2_tpu_torch.ops import query

    for name in KERNELS:
        getattr(query, name).launches = 0


def read_launches() -> dict:
    from xspect2_tpu_torch.ops import query

    return {name: getattr(query, name).launches for name in KERNELS}


def probe_sectors(idx, hi, lo, seen) -> int:
    """The 32 B sectors of the table that the probes of the canonical
    k-mers ``(hi, lo)`` (int64 on the card) read, as K2 and K3 address
    them: marks each in ``seen`` (one bool per sector of the table) and
    returns the sum over k-mers of the distinct sectors each reads."""
    from xspect2_tpu_torch.core.hashing import MASK32, kmer_hash_words_torch

    a, b, c = kmer_hash_words_torch(hi, lo)
    rpb = idx.rows_per_block
    i = torch.arange(idx.num_hashes, dtype=torch.int64, device=hi.device)
    rows = ((b[:, None] + i * c[:, None]) & MASK32) & (rpb - 1)
    if idx.fields_per_word == 1:  # the same rows of every class word
        rows = torch.cat([rows + w * rpb for w in range(idx.class_words)], dim=1)
    words = (a % idx.num_blocks)[:, None] * (idx.class_words * rpb) + rows
    sectors = (words // (SECTOR_BYTES // 4)).sort(dim=1).values
    seen[sectors.reshape(-1)] = True
    return len(sectors) + int((sectors[:, 1:] != sectors[:, :-1]).sum())


def table_sectors(idx) -> torch.Tensor:
    """One bool per 32 B sector of the index's device table, all False."""
    words = idx.num_blocks * idx.class_words * idx.rows_per_block
    return torch.zeros(words * 4 // SECTOR_BYTES, dtype=torch.bool, device="cuda")


# ---------------------------------------------------------------- phase 1


def build_all():
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

    cases = [  # (classes, num_hashes, read_len, step)
        (8, 2, 150, 1), (8, 2, 300, 4), (1, 3, 150, 2), (1, 3, 300, 1),
        (40, 7, 300, 1), (40, 7, 150, 2), (512, 3, 150, 4), (512, 3, 300, 2),
    ]
    dev = torch.device("cuda")
    for num_classes, h, read_len, step in cases:
        idx = random_index(num_classes, h, rng)
        n, n_pad = 3000, 3072  # 72 padding rows, poisoned by the wire
        reads = rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)
        reads[rng.integers(0, n, 40), rng.integers(0, read_len, 40)] = 255
        wire = [torch.from_numpy(a).to(dev) for a in query.pack_reads_wire(reads, K, n_pad)]
        require(int((wire[1] >= n_pad).sum()) > 0, "the patch list carries no sentinel")
        codes = query.unpack_2bit(*wire, read_len)
        plain_codes = query.unpack_2bit_plain(*wire, read_len)
        errors["unpack_2bit"] = max(
            errors["unpack_2bit"], int((codes.int() - plain_codes.int()).abs().max())
        )
        table = torch.from_numpy(idx.device_table().view(np.int32)).to(dev)
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
    require(errors["unpack_2bit"] == 0, "unpack_2bit disagrees with its plain version")
    require(errors["reads_query"] == 0, "reads_query disagrees with its plain version")


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

    k1_ms = cuda_ms(lambda: query.unpack_2bit(*wire, READ_LEN), 20)
    k1_plain = cuda_ms(lambda: query.unpack_2bit_plain(*wire, READ_LEN), 3)
    k2_ms = cuda_ms(lambda: query.reads_query(codes, engine.table, **geom), 10)
    k2_plain = cuda_ms(lambda: query.reads_query_plain(codes, engine.table, **geom), 1)

    k1_bytes = wire[0].numel() + 8 * wire[1].numel() + codes.numel()
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    # K2: windows without an N reach the table and read their probe
    # words; the bytes bound reads each 32 B sector they touch once
    nk = READ_LEN - K + 1
    seen = table_sectors(idx)
    valid = window_sectors = 0
    for r0 in range(0, n_pad, 32_768):
        hi, lo, bad = query._canonical_windows_plain(codes[r0 : r0 + 32_768].long(), K, nk)
        keep = ~bad
        valid += int(keep.sum())
        window_sectors += probe_sectors(idx, hi[keep], lo[keep], seen)
    run_sectors = int(seen.sum())
    probes = idx.num_hashes * (idx.class_words if idx.fields_per_word == 1 else 1)
    k2_bytes = codes.numel() + run_sectors * SECTOR_BYTES + got.numel() * got.element_size()
    k2_reuse_free_ms = (k2_bytes + (window_sectors - run_sectors) * SECTOR_BYTES) / HBM_BYTES_PER_S * 1e3
    # estimated: ~6 per base to pack and canonicalize, ~60 to hash, 3 per probe
    k2_ops = n_pad * nk * (6 * K + 60) + valid * probes * 3
    k2_bytes_ms = k2_bytes / HBM_BYTES_PER_S * 1e3
    k2_ops_ms = k2_ops / INT_OPS_PER_S * 1e3
    log(
        f"  timing [{card}] unpack_2bit [{n_pad}x{READ_LEN}], {wire[1].numel()} patch "
        f"entries: {k1_ms:.4f} ms, bound {k1_bound:.4f} ms (bytes), plain {k1_plain:.4f} ms"
    )
    log(
        f"  timing [{card}] reads_query [{n_pad}x{READ_LEN}], {valid} windows probed x "
        f"{probes} words: {k2_ms:.4f} ms, bound {max(k2_bytes_ms, k2_ops_ms):.4f} ms "
        f"(bytes {k2_bytes_ms:.4f} reading each of the {run_sectors} table sectors touched once, "
        f"operations {k2_ops_ms:.4f}), plain {k2_plain:.4f} ms"
    )
    log(
        f"  reads_query: {window_sectors} sectors summed over windows ({window_sectors / valid:.3f} "
        f"per window), {run_sectors} distinct over the run; bytes with no reuse between windows "
        f"{k2_reuse_free_ms:.4f} ms"
    )
    log(
        f"  device-side [{card}]: {n / ((k1_ms + k2_ms) / 1e3):.0f} reads/s "
        f"({n} reads, {n_pad} rows; unpack + query kernels)"
    )
    return {
        "unpack_2bit": dict(ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound, bound_by="bytes"),
        "reads_query": dict(
            ms=k2_ms, plain_ms=k2_plain, bound_ms=max(k2_bytes_ms, k2_ops_ms),
            bound_by="bytes" if k2_bytes_ms >= k2_ops_ms else "operations",
        ),
    }


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
        launches["unpack_2bit"] > 0 and launches["reads_query"] > 0,
        f"{kind}: a kernel of the reads path was not launched",
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
    return launches, reads


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
        packed, bad_pos, offsets = engine.upload_records_wire(batch, max_records)
        n_tot = len(batch.codes)
        codes = query.unpack_2bit(packed.view(1, -1), torch.zeros_like(bad_pos), bad_pos, n_tot).view(-1)
        rec, valid = query.records_wire(offsets, batch.num_positions, k=K, step=step)
        p_rec, p_valid = query.records_wire_plain(offsets, batch.num_positions, k=K, step=step)
        err4 = int((rec - p_rec).abs().max()) + int((valid != p_valid).sum())
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


def host_record_counts(idx, codes, step):
    from xspect2_tpu_torch.core import dna

    return idx.count_hits_host(*dna.canonical_kmers(codes, K, step=step))


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


def time_records_kernels(engine, batch, card, errors):
    """K1 (flat), K4 and K3 on one assembly's batch: time, bound, plain time."""
    from xspect2_tpu_torch.ops import query

    max_records = query._next_pow2(max(8, batch.num_records))
    packed, bad_pos, offsets = engine.upload_records_wire(batch, max_records)
    zeros = torch.zeros_like(bad_pos)
    n_tot, n_pos = len(batch.codes), batch.num_positions
    flat = packed.view(1, -1)
    codes = query.unpack_2bit(flat, zeros, bad_pos, n_tot).view(-1)
    require(torch.equal(codes, query.unpack_2bit_plain(flat, zeros, bad_pos, n_tot).view(-1)),
            "unpack_2bit disagrees with its plain version on the flat wire")
    rec, valid = query.records_wire(offsets, n_pos, k=K, step=batch.step)
    p_rec, p_valid = query.records_wire_plain(offsets, n_pos, k=K, step=batch.step)
    errors["records_wire"] = max(errors["records_wire"], int((rec - p_rec).abs().max()) + int((valid != p_valid).sum()))
    geom = dict(max_records=max_records, **engine.geometry())
    shortest = int(np.diff(batch.offsets).min())
    got = query.records_query(codes, rec, valid, engine.table, min_record_len=shortest, **geom)
    want = query.records_query_plain(codes, rec, valid, engine.table, **geom)
    errors["records_query"] = max(errors["records_query"], int((got.long() - want.long()).abs().max()))
    require(errors["records_wire"] == 0 and errors["records_query"] == 0,
            "a records kernel disagrees with its plain version at the main path's shape")

    k1_ms = cuda_ms(lambda: query.unpack_2bit(flat, zeros, bad_pos, n_tot), 20)
    k1_plain = cuda_ms(lambda: query.unpack_2bit_plain(flat, zeros, bad_pos, n_tot), 3)
    k4_ms = cuda_ms(lambda: query.records_wire(offsets, n_pos, k=K, step=batch.step), 20)
    k4_plain = cuda_ms(lambda: query.records_wire_plain(offsets, n_pos, k=K, step=batch.step), 3)
    k3_ms = cuda_ms(lambda: query.records_query(codes, rec, valid, engine.table, min_record_len=shortest, **geom), 10)
    k3_plain = cuda_ms(lambda: query.records_query_plain(codes, rec, valid, engine.table, **geom), 1)

    idx = engine.index
    hi, lo, bad = query._canonical_windows_plain(codes[None].long(), K, n_pos)
    keep = valid & ~bad[0]
    counted = int(keep.sum())
    seen = table_sectors(idx)
    window_sectors = probe_sectors(idx, hi[0, keep], lo[0, keep], seen)
    run_sectors = int(seen.sum())
    del hi, lo, bad, keep
    probes = idx.num_hashes * (idx.class_words if idx.fields_per_word == 1 else 1)
    k1_bytes = packed.numel() + 4 * bad_pos.numel() + n_tot
    k4_bytes = 5 * n_pos + offsets.numel() * 4
    # each 32 B sector of the table that a counted window probes, read once
    k3_bytes = n_tot + 5 * n_pos + run_sectors * SECTOR_BYTES + got.numel() * 4
    k3_reuse_free_ms = (k3_bytes + (window_sectors - run_sectors) * SECTOR_BYTES) / HBM_BYTES_PER_S * 1e3
    # estimated: ~6 per base to pack and canonicalize, ~60 to hash, 3 per probe
    k3_ops = counted * (6 * K + 60 + 3 * probes)
    k3_bytes_ms = k3_bytes / HBM_BYTES_PER_S * 1e3
    k3_ops_ms = k3_ops / INT_OPS_PER_S * 1e3
    out = {
        "unpack_2bit": dict(ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes"),
        "records_wire": dict(ms=k4_ms, plain_ms=k4_plain, bound_ms=k4_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes"),
        "records_query": dict(
            ms=k3_ms, plain_ms=k3_plain, bound_ms=max(k3_bytes_ms, k3_ops_ms),
            bound_by="bytes" if k3_bytes_ms >= k3_ops_ms else "operations",
        ),
    }
    shape = f"{batch.num_records} contigs, {n_pos} positions, step {batch.step}"
    for name, t in out.items():
        log(f"  timing [{card}] {name} ({shape}): {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms")
    log(f"  records_query: {counted} windows probed x {probes} words; {window_sectors} sectors summed "
        f"over windows ({window_sectors / counted:.3f} per window), {run_sectors} distinct over the run; "
        f"bytes bound {k3_bytes_ms:.4f} ms reading each sector touched once, {k3_reuse_free_ms:.4f} ms "
        f"with no reuse between windows; operations {k3_ops_ms:.4f} ms")
    real = int(batch.offsets[-1])
    log(f"  device-side [{card}]: {real / ((k1_ms + k4_ms + k3_ms) / 1e3) / 1e6:.1f} M bases/s "
        f"({real} bases; unpack + wire + query kernels)")
    return out


def run_records(rng, card, errors):
    """Train the 40-class SVM species model, classify held-out assemblies."""
    from xspect2_tpu_torch import classify
    from xspect2_tpu_torch.definitions import get_xspect_model_path
    from xspect2_tpu_torch.model_management import metadata_path
    from xspect2_tpu_torch.models.svm_model import ProbabilisticFilterSVMModel
    from xspect2_tpu_torch.ops import query

    base = WORK / "records"
    names = [f"{100 + i}" for i in range(ASM_CLASSES)]
    genomes = rng.integers(0, 4, size=(ASM_CLASSES, GENOME_LEN), dtype=np.uint8)
    t0 = time.time()
    (base / "cobs").mkdir(parents=True)
    for name, g in zip(names, genomes):
        write_fasta(base / "cobs" / f"{name}.fasta", [(f"{name}_genome", g)])
        (base / "svm" / name).mkdir(parents=True)
        for j in range(2):
            s = int(rng.integers(0, GENOME_LEN - SVM_LEN))
            stretch = genomes[int(name) - 100][s : s + SVM_LEN]
            contigs = simulate_assembly(stretch, rng, f"{name}s{j}", int(rng.integers(5, 100)), gaps=1)
            write_fasta(base / "svm" / name / f"GCF_{name}{j}.fasta", contigs)
    log(f"  wrote {ASM_CLASSES} class genomes and {2 * ASM_CLASSES} SVM assemblies in {time.time() - t0:.1f} s")

    model = ProbabilisticFilterSVMModel(
        K, "SmokeAsm", None, None, "Species", get_xspect_model_path(), kernel="rbf", c=1.0,
        device="cuda",
    )
    reset_launches()
    t0 = time.time()
    model.fit(base / "cobs", base / "svm", display_names={n: f"SmokeAsm {n}" for n in names})
    model.save()
    fit_s = time.time() - t0
    fit_launches = read_launches()
    idx = model.index
    log(f"  fit [{card}]: C={idx.num_classes} h={idx.num_hashes} P={idx.fields_per_word} "
        f"cw={idx.class_words}, {idx.num_blocks} blocks, {idx.nbytes / 1e6:.1f} MB, "
        f"{2 * ASM_CLASSES} SVM assemblies scored, {fit_s:.2f} s; launches {fit_launches}")
    require((idx.num_hashes, idx.fields_per_word, idx.class_words) == (7, 1, 2),
            "the 40-class geometry is not h=7, P=1, cw=2")
    scores = (get_xspect_model_path() / model.slug() / "scores.csv").read_text(encoding="utf-8").splitlines()
    require(len(scores) == 1 + 2 * ASM_CLASSES, "scores.csv has the wrong row count")
    own = [float(row.split(",")[1 + names.index(row.split(",")[-1])]) for row in scores[1:]]
    log(f"  scores.csv: own-class score {min(own):.2f}-{max(own):.2f}")

    held = rng.choice(ASM_CLASSES, HELD_OUT, replace=False)
    in_dir = base / "held_out"
    in_dir.mkdir()
    assemblies, total_bases = [], 0
    for a, ci in enumerate(held):
        contigs = simulate_assembly(genomes[ci], rng, f"a{a:02d}", int(rng.integers(20, 401)))
        total_bases += write_fasta(in_dir / f"asm{a:02d}.fasta", contigs)
        assemblies.append((names[ci], contigs))
    del genomes

    launches = {name: 0 for name in KERNELS}
    for name, v in fit_launches.items():
        launches[name] += v
    for step in (1, 4):
        out = base / f"species_step{step}" / "res.json"
        reset_launches()
        t0 = time.time()
        classify.classify_species("SmokeAsm", in_dir, out, step=step, device="cuda")
        e2e = time.time() - t0
        got = read_launches()
        log(f"  records step {step}: kernel launches {got}")
        require(got["unpack_2bit"] > 0 and got["records_wire"] > 0 and got["records_query"] > 0,
                "a kernel of the records path was not launched")
        require(got["reads_query"] == 0, "the records path launched reads_query")
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

    model = ProbabilisticFilterSVMModel.load(metadata_path("SmokeAsm-species"), device="cuda")
    batch = query.prepare_batch(assemblies[0][1], K, step=1, chunk=model.engine.chunk)
    return launches, time_records_kernels(model.engine, batch, card, errors)


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
    require(launches["unpack_2bit"] > 0 and launches["records_wire"] > 0 and launches["records_query"] > 0,
            "genus assemblies: a kernel of the records path was not launched")
    require(launches["reads_query"] == 0, "genus assemblies: the records path launched reads_query")
    for a, contigs in enumerate(assemblies):
        res = json.loads((out.parent / f"res_{a + 1}.json").read_text(encoding="utf-8"))
        check_assembly_result(res, contigs, genus_idx, 1, rng, f"gasm{a}", exact_hits=True)
    log(f"  end-to-end [{card}] genus assemblies: {GENUS_ASSEMBLIES} assemblies ({total_bases} bases) "
        f"in {e2e:.2f} s, {GENUS_ASSEMBLIES / e2e:.2f} assemblies/s, {total_bases / e2e / 1e6:.2f} M bases/s; "
        f"every N-free window of every contig hit, sampled contigs equal the host reference")
    return launches


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
    build_all()
    errors = {name: 0 for name in KERNELS}
    log("phase 2: kernels against their plain versions")
    check_kernels(rng, errors)
    check_records_kernels(rng, errors)

    log("phase 3: species reads, 8 classes x 4 Mbp")
    genomes = rng.integers(0, 4, size=(8, 4_000_000), dtype=np.uint8)
    species_idx = build_index([f"{1000 + i}" for i in range(8)], genomes)
    require(
        (species_idx.num_hashes, species_idx.fields_per_word) == (2, 4),
        "species geometry is not the headline h=2, P=4",
    )
    sp_launches, sp_reads = run_path("species", species_idx, genomes, rng, card)
    timings = time_kernels(species_idx, sp_reads, card, errors)
    del sp_reads

    log("phase 4: genus reads and genus assemblies, 1 class x 32 Mbp")
    genus_genome = rng.integers(0, 4, size=(1, 32_000_000), dtype=np.uint8)
    genus_idx = build_index(["smoke"], genus_genome)
    ge_launches, ge_reads = run_path("genus", genus_idx, genus_genome, rng, card)
    time_kernels(genus_idx, ge_reads, card, errors)
    del ge_reads
    ga_launches = run_genus_assemblies(genus_genome, genus_idx, rng, card)
    del genus_genome, genus_idx

    log("phase 5: SVM species head on reads")
    check_svm(species_idx, genomes, rng)
    del genomes, species_idx

    log("phase 6: records, 40-class x 4 Mbp SVM species model: fit, then 20 assemblies at steps 1 and 4")
    rec_launches, rec_timings = run_records(rng, card, errors)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        timing = timings[name] if name in timings else rec_timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sp_launches[name] + ge_launches[name] + ga_launches[name] + rec_launches[name],
            "max_abs_err": errors[name], **timing, "library_ms": None,
        })
    log(
        f"kernels [{card}]: launches summed over every main-path run (species and genus reads, "
        f"genus assemblies, the 40-class fit and both assembly runs); unpack_2bit and "
        f"reads_query timed at the species reads shape, records_wire and records_query at one "
        f"4 Mbp assembly; whole run {time.time() - t_start:.1f} s"
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
