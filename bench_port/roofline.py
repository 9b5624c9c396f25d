"""Roofline counts of the port's lookup kernels, from the deployment's work.

The bound of a request is the least time the card could take for its
lookups: the larger of its bytes over the peak memory bandwidth and its
integer operations over the peak integer rate (``peaks.json``).  Both
are functions of what the deployment asks, not of any kernel's launch
or layout:

- bytes: the bases in (one byte a base), the record offsets in (4 B a
  record, records route), the hit counts out (4 B a record and class),
  and the table words the probes need, each read once a request: the
  expected number of distinct signature rows that ``counted * h`` probes
  land on among the table's rows, ``rows * (1 - exp(-probes / rows))``,
  times the bytes of a probe row (``4 * class_words``, or 4 where P
  signature rows share a word);
- operations: ``WINDOW_OPS + TABLE_OPS`` a counted k-mer (pack, canonical
  form, hash, block and row arithmetic) and 3 a probe word (load, shift
  and AND), the counts ``chip_smoke.py``'s bounds use.

A counted k-mer is a window of the record, at the step, with no N.  One
request is one launch of the lookup kernel (its file is one batch), so
the bounds of a window's requests add up.  (Written after
``reads_bound`` and ``records_bound`` of ``chip_smoke.py``, which count
32 B sectors of the port's row-major table: a layout, so not kept.)
"""

import json
import math
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text(encoding="utf-8"))
WINDOW_OPS = 90
TABLE_OPS = 10


def distinct_rows(probes: float, rows: int) -> float:
    """Expected distinct rows hit by ``probes`` uniform probes."""
    return rows * -math.expm1(-probes / rows)


def lookup_bound(geom: dict, bases: int, records: int, counted: int, offsets: bool) -> dict:
    """The bound of one lookup launch over ``records`` records of
    ``bases`` bases with ``counted`` counted k-mers: ``{"bytes", "ops",
    "seconds", "by"}``.  ``geom``: ``num_blocks``, ``rows_per_block``,
    ``num_hashes``, ``fields_per_word``, ``num_classes`` (the index the
    configuration states)."""
    h, p, c = geom["num_hashes"], geom["fields_per_word"], geom["num_classes"]
    class_words = max(1, (c + 31) // 32)
    row_bytes = 4 * class_words if p == 1 else 4
    table_rows = geom["num_blocks"] * geom["rows_per_block"]
    words = distinct_rows(counted * h, table_rows)
    nbytes = bases + (4 * (records + 1) if offsets else 0) + 4 * records * c + words * row_bytes
    probe_words = h * (class_words if p == 1 else 1)
    ops = counted * (WINDOW_OPS + TABLE_OPS + 3 * probe_words)
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    t_ops = ops / PEAKS["int_ops_per_s"]
    return dict(bytes=nbytes, ops=ops, seconds=max(t_bytes, t_ops),
                by="bytes" if t_bytes >= t_ops else "operations")


def window_bounds(geom: dict, lookup: dict, pool: list, done: list) -> dict:
    """``{kernel: seconds}``: the bound of the lookup kernel ``lookup``
    names over the completed requests ``done`` of ``pool``, one launch a
    request (``lookup["offsets"]``: the records route's)."""
    return {lookup["kernel"]: sum(
        lookup_bound(geom, sum(pool[r.pool_index].lengths), r.records, pool[r.pool_index].counted,
                     lookup["offsets"])["seconds"]
        for r in done)}


def counted_kmers(records, k: int, step: int) -> int:
    """Windows at ``step`` without an N over code arrays (255 = N)."""
    import numpy as np

    total = 0
    for codes in records:
        n = len(codes) - k + 1
        if n <= 0:
            continue
        bad = np.concatenate([[0], np.cumsum(codes > 3)])
        starts = np.arange(0, n, step)
        total += int(((bad[starts + k] - bad[starts]) == 0).sum())
    return total


def counted_read_kmers(reads, k: int, step: int) -> int:
    """:func:`counted_kmers` of equal-length reads [n, L] at once."""
    import numpy as np

    n, length = reads.shape
    bad = np.concatenate([np.zeros((n, 1), dtype=np.int64), np.cumsum(reads > 3, axis=1)], axis=1)
    starts = np.arange(0, length - k + 1, step)
    return int(((bad[:, starts + k] - bad[:, starts]) == 0).sum())
