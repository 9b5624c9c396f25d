"""Roofline counts of the MLST typing kernels, K5 and K6, from the typing
work of the requests (the units and peaks of ``roofline.py``).

A record is typed in length groups: the loci of one allele length share
its pieces (``reference_mlst.split_pieces``; a record under
``SPLIT_MIN_LENGTH`` bases is one piece).  For each group, K5 looks the
pieces' k-mers up in each of the group's locus tables and gives per-piece
counts; K6 sums them per record, each count over the threshold.  What the
work needs, whatever the kernels' launches or layout:

- K5 bytes: the pieces' bases in (one byte a base) and their offsets (4 B
  a piece and one more), each table's rows the probes land on, each read
  once (``roofline.distinct_rows`` of the group's counted k-mers times
  ``num_hashes``, times the bytes of a probe row), and the per-piece
  counts out (4 B a piece and allele); operations: ``WINDOW_OPS`` a
  counted k-mer once for the group, and ``TABLE_OPS`` plus 3 a probe word
  for each table;
- K6 bytes: the per-piece counts in, the pieces' record ids (4 B a
  piece) and the record's counts out (4 B an allele); operations: 2 a
  count (the compare and the add).

A bound is the larger of its bytes over the peak bandwidth and its
operations over the peak integer rate, a group at a time.
"""

from bench_port import roofline
from bench_port.reference import geometry
from bench_port.reference_mlst import SPLIT_MIN_LENGTH, split_pieces

K5 = "multi_records_query_kernel"
K6 = "segment_reduce_kernel"


def _seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / roofline.PEAKS["hbm_bytes_per_s"], ops / roofline.PEAKS["int_ops_per_s"])


def locus_geometries(config: dict, scheme) -> dict:
    """Each locus's stated index geometry, sized for its longest allele."""
    k = config["k"]
    out = {}
    for locus, alleles in scheme.loci.items():
        names = scheme.allele_names(locus)
        longest = max(max(0, len(a) - k + 1) for a in alleles)
        out[locus] = geometry({**config, "class_names": names}, max(1, longest))
    return out


def record_bounds(config: dict, scheme, geoms: dict, codes, step: int) -> dict:
    """``{K5: seconds, K6: seconds}`` of typing one record (code array)."""
    k = config["k"]
    groups = {}
    for locus, alleles in scheme.loci.items():
        groups.setdefault(len(alleles[0]), []).append(locus)
    k5 = k6 = 0.0
    for length, loci in groups.items():
        pieces = split_pieces(codes, length, k) if len(codes) >= SPLIT_MIN_LENGTH else [codes]
        n = len(pieces)
        counted = roofline.counted_kmers(pieces, k, step)
        k5_bytes = sum(len(p) for p in pieces) + 4 * (n + 1)
        k5_ops = counted * roofline.WINDOW_OPS
        k6_bytes = 4 * n
        k6_ops = 0
        for locus in loci:
            g = geoms[locus]
            c, h, p = g["num_classes"], g["num_hashes"], g["fields_per_word"]
            class_words = max(1, (c + 31) // 32)
            row_bytes = 4 * class_words if p == 1 else 4
            rows = g["num_blocks"] * g["rows_per_block"]
            k5_bytes += roofline.distinct_rows(counted * h, rows) * row_bytes + 4 * n * c
            k5_ops += counted * (roofline.TABLE_OPS + 3 * h * (class_words if p == 1 else 1))
            k6_bytes += 4 * n * c + 4 * c
            k6_ops += 2 * n * c
        k5 += _seconds(k5_bytes, k5_ops)
        k6 += _seconds(k6_bytes, k6_ops)
    return {K5: k5, K6: k6}


def window_bounds(config: dict, scheme, pool: list, done: list, step: int) -> dict:
    """``{K5: seconds, K6: seconds}`` over the completed requests ``done``
    of ``pool``: each pool file's records, once per request."""
    geoms = locus_geometries(config, scheme)
    per_file = {}
    total = {K5: 0.0, K6: 0.0}
    for r in done:
        if r.pool_index not in per_file:
            bounds = [record_bounds(config, scheme, geoms, codes, step) for codes in pool[r.pool_index].records]
            per_file[r.pool_index] = {name: sum(b[name] for b in bounds) for name in total}
        for name in total:
            total[name] += per_file[r.pool_index][name]
    return total
