"""Gather-then-select (K8) against the shipped read query (K2).

The shipped read query (``reads_query``, kernel K2) reads only the probe
words of each k-mer's table block.  The other formulation gathers the
whole 512-byte block of every k-mer and ANDs its selected rows
afterwards; this tool runs that pipeline with the selection as a kernel
of its own (``probe_select``, kernel K8) and holds both side by side on
the same random table and reads:

1. the hash prologue: pack, canonicalize and hash every window of a
   chunk of reads to a block id and ``num_hashes`` row ids (PyTorch);
2. the block gather, ``table.index_select(0, block)`` (PyTorch);
3. the pack of the row ids into a row mask per k-mer (PyTorch);
4. K8: the AND of the selected rows of each class word;
5. the per-read, per-class counts of the set bits (PyTorch).

It prints reads/s of both and whether their counts are equal, the
counterpart of the JAX package's ``tools/microbench_pallas.py``::

    python -m xspect2_tpu_torch.tools.microbench_probe [--table-mb 50] [--classes 8]

It runs on the CUDA card; ``--device cpu`` runs the kernels' plain
versions at whatever size is asked for (a check of the pipeline, not a
measurement).
"""

import argparse
import sys
import time

import numpy as np
import torch

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.core.hashing import block_words_fieldbase_torch
from xspect2_tpu_torch.ops import query
from xspect2_tpu_torch.ops.probe_select import BLOCK_WORDS, probe_select

READ_LEN = 150
K = 21


def geometry(num_classes: int, num_hashes: int, table_mb: float) -> dict:
    """The unpacked (one row per word) geometry of a ``table_mb`` table of
    512-byte blocks, as :func:`~xspect2_tpu_torch.ops.query.reads_query`
    takes it."""
    class_words = max(1, (num_classes + 31) // 32)
    rows_per_block = max(8, BLOCK_WORDS // class_words)
    if rows_per_block * class_words != BLOCK_WORDS:
        raise ValueError(f"{num_classes} classes do not fill a {BLOCK_WORDS}-word block")
    return dict(
        k=K, num_blocks=int(table_mb * 1e6 / (BLOCK_WORDS * 4)), rows_per_block=rows_per_block,
        class_words=class_words, num_hashes=num_hashes, fields_per_word=1, num_classes=num_classes,
    )


def pack_row_mask(rows: torch.Tensor, rows_per_block: int) -> torch.Tensor:
    """Row ids int64 [T, h] -> the row mask int32 [T, W] (uint32 bits)."""
    sel_words = max(1, rows_per_block // 32)
    words = []
    for w in range(sel_words):
        acc = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
        for h in range(rows.shape[1]):
            rh = rows[:, h]
            acc |= torch.where((rh >> 5) == w, torch.ones_like(rh) << (rh & 31), 0)
        words.append(acc)
    return torch.stack(words, dim=1).to(torch.int32)


def class_counts(anded: torch.Tensor, n_reads: int, num_classes: int) -> torch.Tensor:
    """AND words int32 [n_reads * nk, cw] -> int32 [n_reads, C] set-bit counts."""
    class_words = anded.shape[1]
    words = (anded.long() & 0xFFFFFFFF).view(n_reads, -1, class_words)
    out = torch.empty((n_reads, num_classes), dtype=torch.int32, device=anded.device)
    for w in range(class_words):
        for bit in range(min(32, num_classes - 32 * w)):
            out[:, 32 * w + bit] = ((words[:, :, w] >> bit) & 1).sum(dim=1)
    return out


def gather_select_query(reads: torch.Tensor, table: torch.Tensor, geom: dict, reads_per_chunk: int):
    """The gather-then-select pipeline over uint8 ``reads`` [N, L], a chunk
    of ``reads_per_chunk`` reads at a time: int32 [N, C]."""
    nk = reads.shape[1] - K + 1
    rpb, cw = geom["rows_per_block"], geom["class_words"]
    out = []
    for r0 in range(0, reads.shape[0], reads_per_chunk):
        chunk = reads[r0 : r0 + reads_per_chunk]
        hi, lo, _bad = query._canonical_windows_plain(chunk.long(), K, nk)
        block, rows, _g = block_words_fieldbase_torch(
            hi.reshape(-1), lo.reshape(-1), geom["num_blocks"], rpb, geom["num_hashes"]
        )
        blocks = table.index_select(0, block)
        anded = probe_select(pack_row_mask(rows, rpb), blocks, rows_per_block=rpb, class_words=cw)
        out.append(class_counts(anded, chunk.shape[0], geom["num_classes"]))
    return torch.cat(out)


def run(table_mb=50.0, classes=8, num_hashes=7, reads=65536, reads_per_chunk=8192, iters=4,
        device=None) -> dict:
    """Run both formulations; returns their rates and whether they agree."""
    device = resolve_device(device)
    if reads % reads_per_chunk:
        raise ValueError("--reads must be a multiple of --reads-per-chunk")
    geom = geometry(classes, num_hashes, table_mb)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        rng.integers(0, 2**32, size=(geom["num_blocks"], BLOCK_WORDS), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)
    ).to(device)
    # the gather feeds K8 blocks in the TPU's class-word-major layout; K2
    # reads the same words in the index's row-major layout
    row_major = table.view(-1, geom["class_words"], geom["rows_per_block"]).transpose(1, 2)
    row_major = row_major.reshape(table.shape)
    codes = torch.from_numpy(rng.integers(0, 4, size=(reads, READ_LEN), dtype=np.uint8)).to(device)
    nk = READ_LEN - K + 1

    def bench(fn, label):
        result = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        for _ in range(iters):
            last = fn()
        int(last.sum())  # ends the timed region with a fetch
        dt = (time.time() - t0) / iters
        print(f"{label}: {reads / dt:,.0f} reads/s ({reads / dt * nk / 1e6:.1f} M kmers/s)",
              flush=True)
        return result, reads / dt

    print(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'plain versions'}); "
          f"table {geom['num_blocks']} blocks x {BLOCK_WORDS} words, C={classes}, h={num_hashes}, "
          f"{reads} reads x {READ_LEN} bp, {reads_per_chunk} reads ({reads_per_chunk * nk} k-mers) per chunk",
          flush=True)
    want, k2_rate = bench(
        lambda: query.reads_query(codes, row_major, step=1, **geom).to(torch.int32), "reads_query ")
    got, k8_rate = bench(
        lambda: gather_select_query(codes, table, geom, reads_per_chunk), "probe_select")
    equal = bool(torch.equal(got, want))
    print("probe_select == reads_query:", equal, flush=True)
    return {"equal": equal, "reads_query_reads_per_s": k2_rate, "probe_select_reads_per_s": k8_rate,
            "kmers_per_chunk": reads_per_chunk * nk}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--table-mb", type=float, default=50)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--num-hashes", type=int, default=7)
    ap.add_argument("--reads", type=int, default=65536)
    ap.add_argument("--reads-per-chunk", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.table_mb, args.classes, args.num_hashes, args.reads, args.reads_per_chunk,
              args.iters, args.device)
    return 0 if res["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
