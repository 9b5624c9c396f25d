"""The roofline counts against hand-worked shapes."""

import math

import numpy as np
import pytest

from bench_port import roofline

HBM, OPS = 3.35e12, 67e12


def test_species_reads_bound_by_hand():
    # 40 classes (cw = 2, 64 rows a block), h = 7, P = 1; 20,000 reads of 150 bp, all clean
    geom = dict(num_blocks=779_424, rows_per_block=64, num_hashes=7, fields_per_word=1, num_classes=40)
    counted = 20_000 * 130
    rows = 779_424 * 64
    distinct = rows * (1 - math.exp(-counted * 7 / rows))
    nbytes = 20_000 * 150 + 20_000 * 40 * 4 + distinct * 8
    ops = counted * (90 + 10 + 3 * 14)
    b = roofline.lookup_bound(geom, 20_000 * 150, 20_000, counted, offsets=False)
    assert b["bytes"] == pytest.approx(nbytes) and b["ops"] == ops
    assert b["seconds"] == pytest.approx(max(nbytes / HBM, ops / OPS)) and b["by"] == "bytes"


def test_genus_assembly_bound_by_hand():
    # one class packed 32 signature rows a word (a probe reads one word), offsets in
    geom = dict(num_blocks=487_000, rows_per_block=128, num_hashes=7, fields_per_word=32, num_classes=1)
    bases, records, counted = 4_000_000, 200, 3_990_000
    rows = 487_000 * 128
    nbytes = bases + 4 * 201 + 4 * 200 + rows * -math.expm1(-counted * 7 / rows) * 4
    b = roofline.lookup_bound(geom, bases, records, counted, offsets=True)
    assert b["bytes"] == pytest.approx(nbytes)
    assert b["ops"] == counted * (100 + 21)


def test_distinct_rows_runs_from_every_probe_to_every_row():
    assert roofline.distinct_rows(10, 1e12) == pytest.approx(10, rel=1e-9)
    assert roofline.distinct_rows(1e9, 1000) == pytest.approx(1000)


def test_counted_kmers_skip_windows_with_an_n_and_keep_the_step():
    codes = np.array([0, 1, 2, 3, 255, 0, 1, 2, 3, 0], dtype=np.uint8)
    # windows of 3 start at 0..7; the N at 4 spoils those at 2, 3 and 4
    assert roofline.counted_kmers([codes], 3, 1) == 5
    assert roofline.counted_kmers([codes], 3, 2) == 2  # starts 0, 2, 4, 6
    reads = np.stack([codes, codes])
    assert roofline.counted_read_kmers(reads, 3, 1) == 10
    assert roofline.counted_read_kmers(reads, 3, 2) == 4
    assert roofline.counted_kmers([codes[:2]], 3, 1) == 0
