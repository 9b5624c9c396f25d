"""Read simulation utilities.

The port's own copy of the JAX package's read simulation:
length-weighted uniform extraction of fixed-length reads from a genome
with a seeded RNG, plus a seeded substitution/indel sequencing-error
model (NovaSeq-like).
"""

import numpy as np

from xspect2_tpu_torch.io.fasta import SeqRecord, get_record_iterator


def extract_random_reads(
    genome_path,
    read_length: int = 150,
    num_reads: int = 1000,
    seed: int = 42,
) -> list[SeqRecord]:
    """Extract ``num_reads`` random fixed-length reads from a genome file."""
    rng = np.random.default_rng(seed)
    records = [
        rec for rec in get_record_iterator(genome_path) if len(rec.seq) >= read_length
    ]
    if not records:
        raise ValueError("No contigs long enough for the requested read length")

    lengths = np.array([len(rec.seq) - read_length + 1 for rec in records], dtype=float)
    probs = lengths / lengths.sum()

    reads = []
    for i in range(num_reads):
        ri = int(rng.choice(len(records), p=probs))
        start = int(rng.integers(0, len(records[ri].seq) - read_length + 1))
        reads.append(
            SeqRecord(
                records[ri].seq[start : start + read_length],
                id=f"read_{i}_{records[ri].id}_{start}",
                description="",
            )
        )
    return reads


def mutate_read_codes(
    reads: np.ndarray,
    sub_rate: float = 0.001,
    indel_rate: float = 1e-4,
    seed: int = 0,
) -> np.ndarray:
    """Seeded NovaSeq-like error model over a ``[N, L]`` uint8 code matrix.

    Substitutions at ``sub_rate`` per base (each errored base becomes a
    uniformly random DIFFERENT base — Illumina errors are substitution-
    dominated at ~0.1%), plus rare indels at ``indel_rate`` per base:
    a deletion shifts the tail left and pads the final cycle with a
    random base, an insertion shifts the tail right and drops the last
    base (the sequencer always reports exactly L cycles).  Codes >= 4
    (ambiguous/N placeholders) are left untouched.  Returns a new
    array; the input is not modified.
    """
    rng = np.random.default_rng(seed)
    out = np.array(reads, dtype=np.uint8, copy=True)
    n, length = out.shape

    acgt = out < 4
    sub = (rng.random(out.shape) < sub_rate) & acgt
    # +1..+3 mod 4 => always a different base
    out[sub] = (out[sub] + rng.integers(1, 4, size=int(sub.sum()))) % 4

    # indels are ~10x rarer than substitutions on Illumina; the affected
    # read set is small, so a per-read loop is fine and keeps the
    # shift semantics obvious
    n_indels = rng.binomial(length, indel_rate, size=n)
    for ri in np.nonzero(n_indels)[0]:
        for _ in range(int(n_indels[ri])):
            j = int(rng.integers(0, length))
            if rng.random() < 0.5:  # deletion at j
                out[ri, j:-1] = out[ri, j + 1 :]
                out[ri, -1] = rng.integers(0, 4)
            else:  # insertion at j
                out[ri, j + 1 :] = out[ri, j:-1]
                out[ri, j] = rng.integers(0, 4)
    return out


def mutate_sequence(
    seq: str, sub_rate: float = 0.001, indel_rate: float = 1e-4, seed: int = 0
) -> str:
    """String-level wrapper over :func:`mutate_read_codes` (ACGT only)."""
    from xspect2_tpu_torch.core import dna

    codes = dna.encode(seq).reshape(1, -1)
    mutated = mutate_read_codes(
        codes, sub_rate=sub_rate, indel_rate=indel_rate, seed=seed
    )[0]
    return "".join("ACGTN"[min(int(c), 4)] for c in mutated)
