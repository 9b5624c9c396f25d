"""A/B microbenchmark of the read query's body formulations (kernel K10).

The port of the JAX package's ``tools/microbench_body.py``: the same
seven formulations, the same flags, seeds and printed lines.  Each is a
kernel of its own (``ops/body_variants.py``, ``csrc/body_variants.cu``)
over the same random table and reads; they share the hash prologue and
read each k-mer's whole 512 B block, and differ in how they select the
probe rows (``h`` compare-and-sum passes, or one mask and one AND-reduce)
and count (bit planes, byte lanes, or not at all).  ``gatheronly`` is the
whole-block gather alone, the formulations' roofline::

    python -m xspect2_tpu_torch.tools.microbench_body [--table-mb 50] [--classes 8]

Each prints reads/s and k-mers/s on the host clock (one warm-up call,
then ``--iters`` calls, stopped after the card has finished them), then
whether the counting variants equal ``current``.  ``--device cpu`` runs
the plain versions at whatever size is asked for (a check, not a
measurement).
"""

import argparse
import sys

import numpy as np
import torch

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.ops.body_variants import CLASS_WORD_MAJOR, VARIANTS, body_variants, class_word_major, geometry
from xspect2_tpu_torch.tools._synthetic import K, READ_LEN, log, seconds_per_call


def inputs(table_mb: float, classes: int, reads: int, device):
    """The JAX tool's table and reads (``default_rng(0)``, table first) and
    its class-word-major copy: ``(table, table_cwm, codes)``, the tables
    int32 [num_blocks, 128] (uint32 bits), the codes uint8 [reads, 150]."""
    class_words, rows_per_block = geometry(classes)
    rw = rows_per_block * class_words
    num_blocks = int(table_mb * 1e6 / (rw * 4))
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.integers(0, 2**32, size=(num_blocks, rw), dtype=np.uint32).view(np.int32)).to(device)
    codes = torch.from_numpy(rng.integers(0, 4, size=(reads, READ_LEN), dtype=np.uint8)).to(device)
    return table, class_word_major(table, classes), codes


def event_ms(fn, iters: int) -> float:
    """Milliseconds a call of ``fn`` between two CUDA events around
    ``iters`` calls, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(table_mb=50.0, classes=8, num_hashes=7, reads=65536, reads_per_chunk=8192, iters=4, device=None) -> dict:
    """Every variant in the JAX tool's order: its rate and outputs, and
    whether the counting variants equal ``current``."""
    device = resolve_device(device)
    if reads % reads_per_chunk:
        raise ValueError("--reads must be a multiple of --reads-per-chunk")
    log(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu (plain versions)'}")
    table, table_cwm, codes = inputs(table_mb, classes, reads, device)
    nk = READ_LEN - K + 1
    res = {"num_blocks": table.shape[0], "nbytes": table.numel() * 4, "kmers": reads * nk, "variants": {}, "outs": {},
           "equal": {}}
    for name in VARIANTS:
        t = table_cwm if name in CLASS_WORD_MAJOR else table

        def fn(name=name, t=t):
            return body_variants(name, codes, t, num_classes=classes, num_hashes=num_hashes,
                                 reads_per_chunk=reads_per_chunk)

        dt, out = seconds_per_call(fn, iters, device)
        res["outs"][name] = out.cpu().numpy()
        rps = reads / dt
        print(f"{name:10s} {rps:>12,.0f} reads/s  ({rps * nk / 1e6:.1f} M kmers/s)", flush=True)
        ms = event_ms(fn, iters) if device.type == "cuda" else None
        res["variants"][name] = {"reads_per_s": rps, "kmers_per_s": rps * nk, "device_ms": ms}

    outs = res["outs"]
    for name in ("reduceand", "cwmajor", "cwmajor_p4"):
        same = bool(np.array_equal(outs["current"], outs[name]))
        res["equal"][name] = same
        print(f"current == {name}: {same}")
        if not same:
            log("first diffs:", np.argwhere(outs["current"] != outs[name])[:5])
    return res


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
    res = run(args.table_mb, args.classes, args.num_hashes, args.reads, args.reads_per_chunk, args.iters,
              args.device)
    return 0 if all(res["equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
