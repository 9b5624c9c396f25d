"""Synthetic genomes, reads and draft assemblies, and their files.

Frozen copies, so that a later change to the program cannot move the
yardstick:

- :func:`make_genomes` is the genome draw of ``build_index`` in
  ``xspect2_tpu_torch/tools/_synthetic.py`` (uniform random bases, one
  row a class), without the index that function also builds;
- :func:`simulate_reads` is ``simulate_reads`` of the same file (150 bp
  reads of random class, position and strand, ~0.2% of them with one N),
  taking a generator instead of a seed;
- :func:`sequencing_run` adds to it what a run of a sequencer holds
  besides: reads of genomes outside the model and substitution errors;
- :func:`simulate_assembly` is ``simulate_assembly`` of ``chip_smoke.py``
  (contigs with long-tailed lengths cut end to end, 1% substitutions,
  every other contig reverse-complemented, 100-N scaffold gaps).

Every draw comes from the ``numpy.random.Generator`` passed in, so one
seed gives the same bytes.  Codes are 0-3 for ACGT and 255 for N.
"""

from pathlib import Path

import numpy as np

ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def make_genomes(rng: np.random.Generator, num_classes: int, genome_len: int) -> np.ndarray:
    """``num_classes`` random genomes of ``genome_len`` bases: uint8 [C, L]."""
    return rng.integers(0, 4, size=(num_classes, genome_len), dtype=np.uint8)


def simulate_reads(genomes: np.ndarray, num_reads: int, rng: np.random.Generator,
                   read_len: int = 150, n_rate: float = 0.002):
    """Reads of random class, position and strand: ``(reads [n, read_len]
    uint8, cls [n])``; ``n_rate`` of them carry one N (255)."""
    num_classes, genome_len = genomes.shape
    cls = rng.integers(0, num_classes, size=num_reads)
    pos = rng.integers(0, genome_len - read_len, size=num_reads)
    idx = pos[:, None] + np.arange(read_len)[None, :]
    reads = genomes[cls[:, None], idx]
    rc = rng.random(num_reads) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    reads = reads.astype(np.uint8)
    bad = rng.random(num_reads) < n_rate
    reads[bad, rng.integers(0, read_len, size=int(bad.sum()))] = 255
    return reads, cls


def sequencing_run(genomes: np.ndarray, foreign: np.ndarray, num_reads: int, num_foreign: int,
                   rng: np.random.Generator, read_len: int = 150, n_rate: float = 0.002,
                   subst_rate: float = 0.0) -> np.ndarray:
    """A FASTQ run's reads [num_reads, read_len]: :func:`simulate_reads`
    of ``genomes``, ``num_foreign`` of them (at random rows) drawn instead
    from ``foreign`` (genomes the model does not hold: other genera,
    contamination), then ``subst_rate`` of the bases substituted (the
    sequencer's errors; an N stays an N)."""
    reads, _ = simulate_reads(genomes, num_reads, rng, read_len, n_rate)
    if num_foreign:
        other, _ = simulate_reads(foreign, num_foreign, rng, read_len, n_rate)
        reads[rng.choice(num_reads, num_foreign, replace=False)] = other
    if subst_rate:
        hit = (rng.random(reads.shape) < subst_rate) & (reads <= 3)
        reads[hit] = (reads[hit] + rng.integers(1, 4, size=int(hit.sum()), dtype=np.uint8)) % 4
    return reads


def simulate_assembly(genome: np.ndarray, rng: np.random.Generator, name: str, n_contigs: int,
                      subst: float = 0.01, gaps: int = 3):
    """A draft assembly of ``genome``: ``n_contigs`` contigs (> 200 bp,
    long-tailed lengths) cut end to end, ``subst`` of the bases
    substituted, half the contigs reverse-complemented, ``gaps`` 100-N
    scaffold gaps.  Returns ``[(id, codes)]``."""
    g = genome.copy()
    if subst:
        pos = rng.choice(len(g), int(subst * len(g)), replace=False)
        g[pos] = (g[pos] + rng.integers(1, 4, size=len(pos))) % 4
    weights = rng.pareto(1.1, n_contigs) + 0.02
    spare = len(g) - 201 * n_contigs
    lengths = 201 + np.floor(weights / weights.sum() * spare).astype(np.int64)
    lengths[np.argmax(lengths)] += len(g) - lengths.sum()
    ends = np.cumsum(lengths)
    contigs = []
    for i, (e, n) in enumerate(zip(ends, lengths)):
        c = g[e - n : e].astype(np.uint8)
        if i % 2:
            c = (3 - c[::-1]).astype(np.uint8)
        contigs.append([f"{name}_c{i:03d}", c])
    for i in rng.choice(np.nonzero(lengths > 1000)[0], min(gaps, int((lengths > 1000).sum())), replace=False):
        c = contigs[i][1].copy()
        at = int(rng.integers(200, len(c) - 300))
        c[at : at + 100] = 255
        contigs[i][1] = c
    return [tuple(c) for c in contigs]


def write_fasta(path: Path, records) -> int:
    """Write ``[(id, codes)]`` as FASTA with 80-column lines; returns the bases."""
    parts, total = [], 0
    for rid, codes in records:
        seq = ASCII[np.minimum(codes, 4)]
        n = len(seq)
        rows = -(-n // 80)
        lines = np.full(rows * 81, ord("\n"), dtype=np.uint8)
        at = np.arange(n)
        lines[at + at // 80] = seq
        parts += [f">{rid}\n".encode(), lines[: n + rows].tobytes()]
        total += n
    Path(path).write_bytes(b"".join(parts))
    return total


def read_ids(prefix: str, n: int) -> list[str]:
    """The record ids :func:`write_fastq` gives ``n`` reads."""
    width = len(str(max(0, n - 1)))
    return [f"{prefix}{i:0{width}d}" for i in range(n)]


def write_fastq(path: Path, reads: np.ndarray, prefix: str) -> list[str]:
    """Write equal-length reads [n, L] (codes) as FASTQ, quality ``I``;
    returns their ids (``<prefix><zero-padded index>``)."""
    n, read_len = reads.shape
    ids = read_ids(prefix, n)
    head = np.frombuffer("".join(f"@{i}\n" for i in ids).encode(), dtype=np.uint8).reshape(n, -1)
    body = np.empty((n, 2 * read_len + 4), dtype=np.uint8)
    body[:, :read_len] = ASCII[np.minimum(reads, 4)]
    body[:, read_len : read_len + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    body[:, read_len + 3 : 2 * read_len + 3] = ord("I")
    body[:, -1] = ord("\n")
    Path(path).write_bytes(np.concatenate([head, body], axis=1).tobytes())
    return ids
