"""Microbenchmark: does index *order* change the 512 B-row gather rate?

If the slow regime of large tables is bound by the locality of the
device memory, gathering with *sorted* indices should recover part of
the fast rate, which would make a sort -> gather -> unsort pipeline (or
block-axis sharding with sorted routing) pay off for reference-scale
(~400 MB, 40-class) indices.  This is the port of the JAX package's
``tools/microbench_sorted_gather.py``; per table size it measures:

  1. random-index gather (the shipped query's access pattern), K9;
  2. sorted-index gather (upper bound for any routing scheme), K9;
  3. the sort rate with 1 and 3 int32 payloads (the routing cost):
     ``torch.sort`` sorts one tensor, so the keys are sorted and each
     payload is permuted by the returned order, one gather each;
  4. the full pipeline: ``torch.sort``, K9 per row, ``torch.sort`` back,
     a sum.

::

    python -m xspect2_tpu_torch.tools.microbench_sorted_gather [--n 4194304]

``--device cpu`` runs the plain versions (a check, not a measurement).
"""

import argparse
import sys

import numpy as np
import torch

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.core.hashing import MASK32
from xspect2_tpu_torch.ops.row_gather import as_uint32, row_gather
from xspect2_tpu_torch.tools._synthetic import log, random_table, seconds_per_call

TABLE_MB = (50, 100, 200, 400, 800)


def pipeline(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Route k-mers by destination row, gather, restore order, sum: a 0-d
    int64 tensor holding the uint32 sum."""
    si, order = torch.sort(idx)
    payload = row_gather(table, si, mode="per_row")  # stand-in AND word
    _, back_order = torch.sort(order)
    back = payload[back_order]
    return back.sum(dtype=torch.int64) & MASK32


def sort_payloads(keys: torch.Tensor, *payloads: torch.Tensor):
    """The keys sorted, and each payload in the keys' sorted order."""
    sk, order = torch.sort(keys)
    return (sk, *(p[order] for p in payloads))


def run(n=1 << 22, iters=4, row_bytes=512, device=None, table_mb=TABLE_MB) -> dict:
    """Rates of the four measurements and the checksums of the three
    gathers at each table size (they must be equal)."""
    device = resolve_device(device)
    log(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu (plain versions)'}")
    rng = np.random.default_rng(0)
    row_words = row_bytes // 4

    print("table_mb,random_M/s,sorted_M/s,pipeline_M/s")
    rows = []
    for mb in table_mb:
        num_rows = int(mb * 1e6 / row_bytes)
        table = random_table(rng, num_rows, row_words, device)
        idx_np = rng.integers(0, num_rows, size=n, dtype=np.int32)
        idx = torch.from_numpy(idx_np).to(device)
        idx_sorted = torch.from_numpy(np.sort(idx_np)).to(device)

        dt_rand, c_rand = seconds_per_call(lambda: row_gather(table, idx), iters, device)
        dt_sort, c_sort = seconds_per_call(lambda: row_gather(table, idx_sorted), iters, device)
        dt_pipe, c_pipe = seconds_per_call(lambda: pipeline(table, idx), iters, device)
        print(f"{mb},{n / dt_rand / 1e6:.1f},{n / dt_sort / 1e6:.1f},{n / dt_pipe / 1e6:.1f}", flush=True)
        rows.append(dict(
            table_mb=mb, random_per_s=n / dt_rand, sorted_per_s=n / dt_sort, pipeline_per_s=n / dt_pipe,
            checksums=(as_uint32(c_rand), as_uint32(c_sort), int(c_pipe)),
        ))
        del table

    k = torch.from_numpy(rng.integers(0, 2**31, size=n, dtype=np.int32)).to(device)
    p = [torch.from_numpy(rng.integers(0, 2**31, size=n, dtype=np.int32)).to(device) for _ in range(3)]
    dt0, _ = seconds_per_call(lambda: torch.sort(k), iters, device)
    dt1, _ = seconds_per_call(lambda: sort_payloads(k, p[0]), iters, device)
    dt3, _ = seconds_per_call(lambda: sort_payloads(k, *p), iters, device)
    print(f"sort 1 payload: {n / dt1 / 1e6:.1f} M elem/s", flush=True)
    print(f"sort 3 payloads: {n / dt3 / 1e6:.1f} M elem/s", flush=True)
    print(f"sort keys alone (with their order): {n / dt0 / 1e6:.1f} M elem/s; each payload one gather by "
          f"that order, {(dt3 - dt1) / 2 * 1e3:.3f} ms", flush=True)
    return dict(rows=rows, sort_keys_per_s=n / dt0, sort1_per_s=n / dt1, sort3_per_s=n / dt3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--row-bytes", type=int, default=512)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.n, args.iters, args.row_bytes, args.device)
    return 0 if all(len(set(r["checksums"])) == 1 for r in res["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
