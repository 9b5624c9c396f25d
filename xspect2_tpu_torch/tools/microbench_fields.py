"""A/B microbenchmark: field-packed table words vs the unpacked layout.

With C <= 16 classes a uint32 table word uses only C of its 32 bits, so
an unpacked table is 32/C times larger than its information content.
Field packing stores P = 32 // field_bits signature rows per word
(field_bits = smallest power of two >= C); for the 8-class headline this
shrinks the table 4x.  This is the port of the JAX package's
``tools/microbench_fields.py``: the same variants, flags, seeds and
printed lines, with the read query K2 (``ops/query.py:reads_query``)
standing in for each XLA body at that variant's geometry and the fused
gather + sum K9 (``ops/row_gather.py``) for the gather-only roofline::

    python -m xspect2_tpu_torch.tools.microbench_fields [--table-mb 200] [--classes 8]

Variants:
  shipped      - K2 on an UNPACKED (one row a word) table of table-mb
  fields       - K2 on the field-packed table of table-mb/P
  fields_h3/4/5 - the same at 3, 4, 5 probes (tables sized as the JAX tool's)
  fields_r64   - the packed table in 64-row (256 B) blocks
  fields_big   - K2 on a field-packed table of table-mb (same bytes as shipped)
  gather_small - K9 over each k-mer's block of the table-mb/P table
  gather_big   - the same on the table-mb table
  *_i8         - no counterpart: they differ from their neighbours only by
                 XLA's int8 compares inside the body, which K2 fuses into one
                 kernel; they are printed as such.

K2 and K9 run once per chunk of ``--reads-per-chunk`` reads, as the JAX
tool's scan does; the gather variants' block ids are hashed before the
clock starts.  ``--device cpu`` runs the plain versions (a check, not a
measurement).
"""

import argparse
import sys

import numpy as np
import torch

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.core.hashing import kmer_hash_words_torch
from xspect2_tpu_torch.ops import query
from xspect2_tpu_torch.ops.row_gather import row_gather
from xspect2_tpu_torch.tools._synthetic import log, random_table, seconds_per_call

READ_LEN = 150
K = 21
NO_COUNTERPART = ("fields_h4i8", "fields_h3i8", "fields_h2i8", "fields_i8")


def run(table_mb=200.0, classes=8, num_hashes=7, reads=65536, reads_per_chunk=8192, iters=4,
        device=None) -> dict:
    """reads/s of every variant (None for those without a counterpart)."""
    device = resolve_device(device)
    log(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu (plain versions)'}")
    C = classes
    if not 1 <= C <= 16:
        raise ValueError("--classes must be in [1, 16]: field packing needs a word of fields")
    if reads % reads_per_chunk:
        raise ValueError("--reads must be a multiple of --reads-per-chunk")
    fb = 1
    while fb < C:
        fb *= 2
    P = 32 // fb
    rpb = 128  # 512 B blocks
    h = num_hashes
    nk = READ_LEN - K + 1
    rpc = reads_per_chunk
    num_blocks_big = int(table_mb * 1e6 / (rpb * 4))
    num_blocks_small = num_blocks_big // P

    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 4, size=(reads, READ_LEN), dtype=np.uint8)).to(device)
    table_big = random_table(rng, num_blocks_big, rpb, device)
    table_small = random_table(rng, num_blocks_small, rpb, device)
    # variant tables: h=4 formula sizing (fpr still 0.01) is 10.5/9.58
    # bigger bits; rpb=64 keeps the same bytes in 256 B blocks
    nb_h4 = int(num_blocks_small * 10.5 / 9.58)
    table_h4 = random_table(rng, nb_h4, rpb, device)
    nb_h5 = int(num_blocks_small * 9.86 / 9.58)
    table_h5 = random_table(rng, nb_h5, rpb, device)
    nb_h3 = int(num_blocks_small * 12.4 / 9.58)
    table_h3 = random_table(rng, nb_h3, rpb, device)
    table_r64 = table_small.reshape(num_blocks_small * 2, 64)

    def k2(table, nb, nh=h, rpb_v=rpb, fields=P):
        geom = dict(k=K, step=1, num_blocks=nb, rows_per_block=rpb_v, class_words=1, num_hashes=nh,
                    fields_per_word=fields, num_classes=C)
        return lambda: [query.reads_query(codes[r0 : r0 + rpc], table, **geom) for r0 in range(0, reads, rpc)]

    def gather(table, nb):
        blocks = []
        for r0 in range(0, reads, rpc):
            hi, lo, _bad = query._canonical_windows_plain(codes[r0 : r0 + rpc].long(), K, nk)
            a, _, _ = kmer_hash_words_torch(hi.reshape(-1), lo.reshape(-1))
            blocks.append((a % nb).to(torch.int32))
        return lambda: [row_gather(table, b) for b in blocks]

    fns = {
        "shipped": k2(table_big, num_blocks_big, fields=1),
        "fields": k2(table_small, num_blocks_small),
        "fields_h4": k2(table_h4, nb_h4, nh=4),
        "fields_h4i8": None,
        "fields_h3i8": None,
        "fields_h3": k2(table_h3, nb_h3, nh=3),
        "fields_h2i8": None,
        "fields_h5": k2(table_h5, nb_h5, nh=5),
        "fields_r64": k2(table_r64, num_blocks_small * 2, rpb_v=64),
        "fields_i8": None,
        "fields_big": k2(table_big, num_blocks_big),
        "gather_small": gather(table_small, num_blocks_small),
        "gather_big": gather(table_big, num_blocks_big),
    }

    log(
        f"C={C} fb={fb} P={P} big={num_blocks_big * rpb * 4 / 1e6:.0f}MB "
        f"small={num_blocks_small * rpb * 4 / 1e6:.0f}MB"
    )
    rates = {}
    for name, f in fns.items():
        if f is None:
            print(f"{name:12s} {'no counterpart':>12s}: XLA's int8 compares inside the body; K2 fuses the body",
                  flush=True)
            rates[name] = None
            continue
        dt, _ = seconds_per_call(f, iters, device)
        rps = reads / dt
        print(
            f"{name:12s} {rps:>12,.0f} reads/s  "
            f"({rps * nk / 1e6:.1f} M kmers/s)",
            flush=True,
        )
        rates[name] = rps
    return rates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--table-mb", type=float, default=200)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--num-hashes", type=int, default=7)
    ap.add_argument("--reads", type=int, default=65536)
    ap.add_argument("--reads-per-chunk", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(args.table_mb, args.classes, args.num_hashes, args.reads, args.reads_per_chunk, args.iters, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
