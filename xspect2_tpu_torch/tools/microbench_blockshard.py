"""Microbenchmark: per-device rate of one block shard vs the whole table.

Block-axis sharding gives every device a ``1/n_blk`` window of the
signature blocks and has it probe ALL k-mers of its data shard, masking
the ones it does not own (``parallel/block_sharded.py``).  The
per-device cost is the read query on the local window, so the question
is its rate at the window's size.  This is the port of the JAX
package's ``tools/microbench_blockshard.py``: on the reference-scale
40-class / ~400 MB geometry it measures, with the read query K2
(``ops/query.py:reads_query``) and its owned-block mode,

  - the whole-table rate (the single-device / replicated regime),
  - one shard's rate at n_blk in {2, 4, 8} (windows of 200/100/50 MB),

and checks that the owned-block counts of the ``n_blk`` windows that
tile the table sum to the whole table's counts::

    python -m xspect2_tpu_torch.tools.microbench_blockshard [--reads 65536]

The index and reads are the JAX bench's (``tools/_synthetic.py``),
built in memory.  ``--device cpu`` runs the plain versions (a check, not
a measurement).
"""

import argparse
import sys

import numpy as np
import torch

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.ops import query
from xspect2_tpu_torch.tools._synthetic import K, READ_LEN, build_index, log, seconds_per_call, simulate_reads

SHARDS = (2, 4, 8)
# the JAX tool's scan chunk: the reads are cut to a whole number of chunks
READS_PER_CHUNK = 8192


def run(reads=1 << 16, classes=40, genome_mb=4.0, iters=3, device=None, shards=SHARDS) -> dict:
    """Rates of the whole table and of one middle window a shard count,
    and whether the tiling windows' counts sum to the whole table's."""
    device = resolve_device(device)
    log(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu (plain versions)'}")
    index, genomes = build_index(classes, genome_mb)
    codes, _cls = simulate_reads(genomes, reads)
    codes = np.where(codes > 3, 0, codes)  # keep the body identical across runs
    nk = READ_LEN - K + 1
    n = reads // READS_PER_CHUNK * READS_PER_CHUNK
    codes = torch.from_numpy(np.ascontiguousarray(codes[:n], dtype=np.uint8)).to(device)
    log(
        f"index: {index.num_classes} classes, h={index.num_hashes}, "
        f"{index.nbytes / 1e6:.0f} MB, {index.num_blocks} blocks"
    )
    table = query.table_tensor(index, device)
    geom = dict(
        k=index.k, step=1, num_blocks=int(index.num_blocks), rows_per_block=index.rows_per_block,
        class_words=index.class_words, num_hashes=index.num_hashes,
        fields_per_word=index.fields_per_word, num_classes=index.num_classes,
    )

    def counts(local_blocks=None, offset=0):
        if local_blocks is None:
            return query.reads_query(codes, table, **geom)
        return query.reads_query(codes, table[offset : offset + local_blocks], **geom,
                                 local_blocks=local_blocks, block_offset=offset)

    def bench(local_blocks=None, offset=0):
        dt, _ = seconds_per_call(lambda: counts(local_blocks, offset), iters, device)
        return n / dt, n * nk / dt

    whole = counts().long()
    rate, lookups = bench()
    print(f"whole table: {rate / 1e3:.0f} k reads/s ({lookups / 1e6:.0f} M lookups/s)")
    res = {"whole": (rate, lookups), "num_blocks": int(index.num_blocks), "nbytes": index.nbytes,
           "tiles_equal": {}}
    for n_blk in shards:
        local = -(-index.num_blocks // n_blk)
        # keep the window fully inside the table: when num_blocks is not
        # divisible by n_blk a mid-table offset could slice short
        offset = min(local, index.num_blocks - local)  # middle window: representative clamping
        r, lk = bench(local, offset)
        mb = local * index.rows_per_block * index.class_words * 4 / 1e6
        print(
            f"1/{n_blk} shard ({mb:.0f} MB window): {r / 1e3:.0f} k reads/s "
            f"({lk / 1e6:.0f} M lookups/s) per device",
            flush=True,
        )
        tiled = sum(
            counts(min(local, index.num_blocks - o), o).long() for o in range(0, index.num_blocks, local)
        )
        res[n_blk] = (r, lk, mb)
        res["tiles_equal"][n_blk] = bool(torch.equal(tiled, whole))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=1 << 16)
    ap.add_argument("--classes", type=int, default=40)
    ap.add_argument("--genome-mb", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.reads, args.classes, args.genome_mb, args.iters, args.device)
    return 0 if all(res["tiles_equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
