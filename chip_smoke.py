#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels and the native host library from the
sources in the checkout, checks each kernel against its plain PyTorch
version on the card, then classifies simulated reads end to end through
``xspect2_tpu_torch.classify`` at full width: an 8-class species model
over 4 Mbp genomes and a 1-class genus model over 32 Mbp, 400,000
150 bp reads each.  It checks the results against the host reference,
checks that the main path launched both kernels, times each kernel
against its bound and its plain version, and prints one JSON line per
the contract below as its last line:

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

It exits non-zero, printing no result, when CUDA is absent, when the
port cannot be imported, or when any phase fails.  Everything it writes
goes to ``build/chip_smoke/`` (``build/`` is ignored by git).
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0].strip()


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
    # K2: windows without an N reach the table; each reads its probe words
    nk = READ_LEN - K + 1
    bad = (codes > 3).int().cumsum(dim=1)
    bad = torch.cat([torch.zeros((n_pad, 1), dtype=bad.dtype, device=dev), bad], dim=1)
    valid = int(((bad[:, K:] - bad[:, :nk]) == 0).sum())
    probes = idx.num_hashes * (idx.class_words if idx.fields_per_word == 1 else 1)
    # each probe word is a random read of one 32 B sector
    k2_bytes = codes.numel() + valid * probes * SECTOR_BYTES + got.numel() * got.element_size()
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
        f"(bytes {k2_bytes_ms:.4f} with one 32 B sector per probe word, "
        f"operations {k2_ops_ms:.4f}), plain {k2_plain:.4f} ms"
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
    from xspect2_tpu_torch.ops import query

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

    query.unpack_2bit.launches = 0
    query.reads_query.launches = 0
    t0 = time.time()
    facade("Smoke", fastq, out, device="cuda")
    e2e = time.time() - t0
    launches = {"unpack_2bit": query.unpack_2bit.launches, "reads_query": query.reads_query.launches}
    log(f"  {kind}: kernel launches on the main path {launches}")
    require(all(v > 0 for v in launches.values()), f"{kind}: a kernel was not launched")
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
    from xspect2_tpu_torch.models.svm_head import SVMHead

    dev = torch.device("cuda")
    try:
        import sklearn  # noqa: F401
    except ImportError:
        log("  svm: sklearn is not installed here: checking SVMHead on the card "
            "against its CPU float64 run with seeded parameters")
        n_classes, n_sv = idx.num_classes, 40
        per = n_sv // n_classes
        head = SVMHead(
            support_vectors=rng.random((per * n_classes, n_classes)),
            dual_coef=rng.normal(size=(n_classes - 1, per * n_classes)),
            intercept=rng.normal(size=n_classes * (n_classes - 1) // 2),
            n_support=[per] * n_classes, classes=idx.class_names, kernel="rbf", gamma=0.5,
        )
        x = rng.random((1000, n_classes))
        cpu_dec = head.decision_values(x)
        cpu_pred = head.predict(x)
        head = head.to(dev)
        dec = head.decision_values(x).cpu()
        require(torch.allclose(dec, cpu_dec, rtol=1e-9, atol=1e-12), "svm: decisions differ")
        require(head.predict(x) == cpu_pred, "svm: predictions differ from the CPU run")
        log("  svm: SVMHead on the card equals its CPU float64 run (1000 samples)")
        return

    from xspect2_tpu_torch import classify
    from xspect2_tpu_torch.definitions import get_xspect_model_path
    from xspect2_tpu_torch.models.svm_head import fit_svc
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
    want = str(fit_svc(x_train, y_train, "rbf", 1.0).predict(x)[0])
    log(f"  svm: prediction {res['prediction']!r}, sklearn {want!r}, source {idx.class_names[target]!r}")
    require(res["prediction"] == want == idx.class_names[target], "svm: wrong prediction")


# ---------------------------------------------------------------- main


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import xspect2_tpu_torch  # noqa: F401 - fails outside a checkout

    card = card_line()
    log(f"card: {card}")
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    os.environ["XSPECT_DATA_ROOT"] = str(WORK / "xspect-data")
    rng = np.random.default_rng(args.seed)

    log("phase 1: build")
    build_all()
    errors = {"unpack_2bit": 0, "reads_query": 0}
    log("phase 2: kernels against their plain versions")
    check_kernels(rng, errors)

    log("phase 3: species, 8 classes x 4 Mbp")
    genomes = rng.integers(0, 4, size=(8, 4_000_000), dtype=np.uint8)
    species_idx = build_index([f"{1000 + i}" for i in range(8)], genomes)
    require(
        (species_idx.num_hashes, species_idx.fields_per_word) == (2, 4),
        "species geometry is not the headline h=2, P=4",
    )
    sp_launches, sp_reads = run_path("species", species_idx, genomes, rng, card)
    timings = time_kernels(species_idx, sp_reads, card, errors)

    log("phase 4: genus, 1 class x 32 Mbp")
    genus_genome = rng.integers(0, 4, size=(1, 32_000_000), dtype=np.uint8)
    genus_idx = build_index(["smoke"], genus_genome)
    ge_launches, ge_reads = run_path("genus", genus_idx, genus_genome, rng, card)
    time_kernels(genus_idx, ge_reads, card, errors)
    del genus_genome, genus_idx, ge_reads

    log("phase 5: SVM species head")
    check_svm(species_idx, genomes, rng)

    meta = {
        "unpack_2bit": ("xspect2_tpu_torch/csrc/unpack_2bit.cu", "xspect2_tpu/ops/query.py:751"),
        "reads_query": ("xspect2_tpu_torch/csrc/reads_query.cu", "xspect2_tpu/ops/query.py:624"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sp_launches[name] + ge_launches[name],
            "max_abs_err": errors[name], **timings[name], "library_ms": None,
        })
    log(f"kernels: launches on the species and genus runs, timings at the species shape [{card}]")
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
