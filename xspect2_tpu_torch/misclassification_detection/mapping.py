"""Read-to-reference mapping for misclassification detection.

The port's own copy of the JAX package's seed-and-vote mapper, numpy on
the host (no device program): the downstream statistic consumes only the
*primary-alignment start coordinates* (unique (ref, start) pairs) and
the total genome length.  Exact 15-mer seeds are looked up in a sorted
reference seed array, the strand is chosen by vote count, and the start
is the majority-implied alignment start.  The TSV output has the JAX
package's format.
"""

import csv
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from xspect2_tpu_torch.core import dna
from xspect2_tpu_torch.definitions import fasta_endings
from xspect2_tpu_torch.io.fasta import get_record_iterator

SEED_K = 15
MAX_OCCURRENCES = 16  # skip repetitive seeds


@dataclass(frozen=True)
class MappingPreset:
    """Per-read-length-regime mapping parameters.

    The preset follows the first read's length ("sr" for <= 150 bp,
    "map-ont" beyond, as minimap2's presets split them): short accurate reads use a dense seed stride and a
    tight vote-clustering tolerance; long (possibly noisy) reads seed
    more sparsely per base but collect far more seeds overall, and
    cluster votes with a wide tolerance so indels — which shift the
    implied start of every downstream seed — still stack into one
    cluster instead of fragmenting the vote.
    """

    name: str
    seed_stride: int
    start_tolerance: int  # max spread of one vote cluster (absorbs indels)
    min_votes: int


SHORT_READ_PRESET = MappingPreset("sr", seed_stride=7, start_tolerance=12, min_votes=2)
LONG_READ_PRESET = MappingPreset(
    "map-ont", seed_stride=11, start_tolerance=120, min_votes=3
)
SHORT_READ_MAX_LEN = 150


def preset_for_read_length(read_length: int) -> MappingPreset:
    """File-level preset choice by read length (the sr / map-ont split)."""
    return SHORT_READ_PRESET if read_length <= SHORT_READ_MAX_LEN else LONG_READ_PRESET


def _best_start_cluster(starts: np.ndarray, tolerance: int) -> tuple[int, int]:
    """(votes, start) of the densest cluster of implied starts.

    Sorted two-pointer sweep: the best window whose spread is within
    ``tolerance``; the cluster's median is the reported start (robust to
    the indel-shifted outliers at the window edges).
    """
    starts = np.sort(starts)
    best_count, best_start = 0, 0
    lo = 0
    for hi in range(len(starts)):
        while starts[hi] - starts[lo] > tolerance:
            lo += 1
        count = hi - lo + 1
        if count > best_count:
            best_count = count
            best_start = int(np.median(starts[lo : hi + 1]))
    return best_count, best_start


class MappingHandler:
    """Maps reads onto a reference and extracts alignment start coordinates."""

    def __init__(self, ref_genome_path: str, reads_path: str) -> None:
        if not os.path.isfile(ref_genome_path):
            raise ValueError("The path to the reference genome does not exist.")
        if not os.path.isfile(reads_path):
            raise ValueError("The path to the reads does not exist.")
        if not ref_genome_path.endswith(tuple(fasta_endings)) and reads_path.endswith(
            tuple(fasta_endings)
        ):
            raise ValueError("The files must be FASTA-files!")

        stem = reads_path.rsplit(".", 1)[0] + "_mapped"
        self.ref_genome_path = ref_genome_path
        self.reads_path = reads_path
        self.tsv = stem + ".start_coordinates.tsv"
        self._contig_names: list[str] = []
        self._contig_lengths: list[int] = []
        self._alignments: list[tuple[int, str, int]] | None = None

    # ------------------------------------------------------------------ reference indexing

    def _build_reference_index(self):
        codes_parts = []
        offsets = [0]
        for rec in get_record_iterator(Path(self.ref_genome_path)):
            self._contig_names.append(rec.id)
            self._contig_lengths.append(len(rec.seq))
            codes_parts.append(dna.encode(rec.seq))
            # separator of invalid codes so seeds never span contigs
            codes_parts.append(np.full(SEED_K, dna.INVALID, dtype=np.uint8))
            offsets.append(offsets[-1] + len(rec.seq) + SEED_K)
        if not self._contig_names:
            raise ValueError("Reference genome file is empty.")
        codes = np.concatenate(codes_parts)
        _, lo, valid = dna.pack_kmers(codes, SEED_K)
        positions = np.nonzero(valid)[0].astype(np.int64)
        values = lo[positions]
        order = np.argsort(values, kind="stable")
        self._ref_values = values[order]
        self._ref_positions = positions[order]
        self._offsets = np.asarray(offsets[:-1], dtype=np.int64)

    def _global_to_contig(self, gpos: int) -> tuple[int, int]:
        ci = int(np.searchsorted(self._offsets, gpos, side="right")) - 1
        return ci, int(gpos - self._offsets[ci])

    # ------------------------------------------------------------------ mapping

    def _vote_read(
        self, codes: np.ndarray, preset: MappingPreset
    ) -> tuple[int, int] | None:
        """Best (votes, global_start) over both strands, or None if unmapped."""
        n = len(codes)
        if n < SEED_K:
            return None
        best = None
        for ccodes in (codes, dna.revcomp_codes(codes)):
            nk = n - SEED_K + 1
            seed_offsets = list(range(0, nk, preset.seed_stride))
            if (nk - 1) not in seed_offsets:
                seed_offsets.append(nk - 1)
            _, lo, valid = dna.pack_kmers(ccodes, SEED_K)
            implied_starts: list[int] = []
            for off in seed_offsets:
                if not valid[off]:
                    continue
                val = lo[off]
                i0 = np.searchsorted(self._ref_values, val, side="left")
                i1 = np.searchsorted(self._ref_values, val, side="right")
                if i1 - i0 == 0 or i1 - i0 > MAX_OCCURRENCES:
                    continue
                implied_starts.extend(
                    int(gpos) - off for gpos in self._ref_positions[i0:i1]
                )
            if implied_starts:
                count, start = _best_start_cluster(
                    np.asarray(implied_starts, dtype=np.int64),
                    preset.start_tolerance,
                )
                if count >= preset.min_votes and (best is None or count > best[0]):
                    best = (count, max(0, start))
        return best

    def map_reads_onto_reference(self) -> None:
        """Map all reads; keep one primary alignment start per read.

        The mapping preset is chosen from the first read's length
        (:func:`preset_for_read_length`)."""
        self._build_reference_index()
        alignments = []
        preset = None
        for rec in get_record_iterator(Path(self.reads_path)):
            if preset is None:
                preset = preset_for_read_length(len(rec.seq))
            hit = self._vote_read(dna.encode(rec.seq), preset)
            if hit is None:
                continue
            _, gstart = hit
            ci, local = self._global_to_contig(gstart)
            alignments.append((ci, rec.id, local))
        self._alignments = alignments

    def get_total_genome_length(self) -> int:
        if not self._contig_lengths:
            self._build_reference_index()
        return int(sum(self._contig_lengths))

    def extract_starting_coordinates(self) -> None:
        """Write unique (ref, start) primary alignments to the TSV."""
        with open(self.tsv, "w", encoding="utf-8") as tsv:
            tsv.write("reference_genome\tread\tmapped_starting_coordinate\n")
            if self._alignments is None:
                tsv.write("dummy_reference\tdummy_read\t1000\n")
                return
            seen = set()
            for ci, read_id, start in self._alignments:
                key = (ci, start)
                if key in seen:
                    continue
                seen.add(key)
                tsv.write(f"{self._contig_names[ci]}\t{read_id}\t{start}\n")

    def get_start_coordinates(self) -> list[int]:
        coordinates = []
        with open(self.tsv, "r", newline="", encoding="utf-8") as f:
            reader = csv.DictReader(f, delimiter="\t")
            for row in reader:
                val = row.get("mapped_starting_coordinate")
                if val is None:
                    raise ValueError("Column with starting coordinates not found.")
                coordinates.append(int(val))
        return coordinates
