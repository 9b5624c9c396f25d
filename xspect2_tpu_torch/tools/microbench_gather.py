"""Microbenchmark: the card's gather rate against row width and table size.

Question this answers: the query engine issues ONE contiguous-block
gather per k-mer probe.  If g adjacent k-mers shared one (g x wider)
block, gathers drop g-fold while the table grows g-fold: a win only if
the gather rate is insensitive to row width and does not degrade too
much with table size.  This is the port of the JAX package's
``tools/microbench_gather.py``: the same grid, seeds and CSV, with the
fused gather + sum as kernel K9 (``ops/row_gather.py``)::

    python -m xspect2_tpu_torch.tools.microbench_gather [--n 4194304]

``--device cpu`` runs the plain version (a check, not a measurement).
"""

import argparse
import sys

import numpy as np
import torch

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.ops.row_gather import row_gather
from xspect2_tpu_torch.tools._synthetic import log, random_table, seconds_per_call

TABLE_MB = (25, 50, 100, 200, 400)
ROW_BYTES = (128, 256, 512, 1024, 2048, 4096)


def run(n=1 << 22, iters=4, device=None, table_mb=TABLE_MB, row_bytes=ROW_BYTES) -> list[dict]:
    """The grid: one row of the JAX tool's CSV each, as a dict."""
    device = resolve_device(device)
    log(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu (plain versions)'}")
    rng = np.random.default_rng(0)

    def bench(mb: float, width: int, n: int) -> float:
        num_rows = int(mb * 1e6 / width)
        table = random_table(rng, num_rows, width // 4, device)
        idx = torch.from_numpy(rng.integers(0, num_rows, size=n, dtype=np.int32)).to(device)
        dt, _ = seconds_per_call(lambda: row_gather(table, idx), iters, device)
        return n / dt

    print("table_mb,row_bytes,gathers_per_s,GB_per_s")
    rows = []
    for mb in table_mb:
        for width in row_bytes:
            m = n
            # keep per-timing gathered bytes bounded (~4 GB max)
            while m * width > 4e9:
                m //= 2
            r = bench(mb, width, m)
            print(f"{mb},{width},{r / 1e6:.1f}M,{r * width / 1e9:.1f}", flush=True)
            rows.append(dict(table_mb=mb, row_bytes=width, n=m, gathers_per_s=r, GB_per_s=r * width / 1e9))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 22, help="gathers per timing")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(args.n, args.iters, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
