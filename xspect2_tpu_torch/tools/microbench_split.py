"""Does splitting a big table into smaller windows beat the gather cliff?

This is the port of the JAX package's ``tools/microbench_split.py``: it
measures whether ``s`` clamped gathers (one per window of the table,
every index probing each window, an index outside a window adding 0)
beat one gather on the whole table, with kernel K9
(``ops/row_gather.py``) in its window and total modes::

    python -m xspect2_tpu_torch.tools.microbench_split [--table-mb 200]

The windows tile the table: the last one also holds the rows that
``num_rows // s`` leaves over, so every split gives the whole table's
checksum (the JAX tool's windows all have ``num_rows // s`` rows and
drop those rows).  ``--device cpu`` runs the plain version (a check, not
a measurement).
"""

import argparse
import sys

import numpy as np
import torch

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.core.hashing import MASK32
from xspect2_tpu_torch.ops.row_gather import row_gather
from xspect2_tpu_torch.tools._synthetic import log, random_table, seconds_per_call

SPLITS = (2, 3, 4)


def windows(num_rows: int, n_splits: int) -> list[tuple[int, int]]:
    """``(offset, bound)`` of each window: ``num_rows // n_splits`` rows,
    the last one up to the end of the table."""
    bound = num_rows // n_splits
    return [(s * bound, bound if s < n_splits - 1 else num_rows - s * bound) for s in range(n_splits)]


def split_sum(table: torch.Tensor, idx: torch.Tensor, n_splits: int) -> torch.Tensor:
    """One windowed K9 pass per window, summed: a 0-d int64 tensor holding
    the uint32 sum."""
    parts = [
        row_gather(table[offset : offset + bound], idx, mode="window", window=(offset, bound))
        for offset, bound in windows(table.shape[0], n_splits)
    ]
    return torch.stack(parts).sum(dtype=torch.int64) & MASK32


def run(table_mb=200.0, n=1 << 22, iters=4, device=None, splits=SPLITS) -> dict:
    """Rates and checksums of the whole table and of each split."""
    device = resolve_device(device)
    log(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu (plain versions)'}")
    rng = np.random.default_rng(0)
    num_rows = int(table_mb * 1e6 / 512)
    table = random_table(rng, num_rows, 128, device)
    idx = torch.from_numpy(rng.integers(0, num_rows, size=n, dtype=np.int32)).to(device)

    def bench(f, label):
        dt, out = seconds_per_call(lambda: f(table, idx), iters, device)
        out = int(out) & MASK32
        print(f"{label}: {n / dt / 1e6:.1f} M gathers/s (checksum {out})", flush=True)
        return out, n / dt

    res = {"whole": bench(lambda t, i: row_gather(t, i).long() & MASK32, "whole   ")}
    for s in splits:
        res[s] = bench(lambda t, i, s=s: split_sum(t, i, s), f"split x{s}")
        if res[s][0] != res["whole"][0]:
            raise RuntimeError("split result mismatch")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--table-mb", type=float, default=200)
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(args.table_mb, args.n, args.iters, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
