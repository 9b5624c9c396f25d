"""Tiny sizes of the MLST cell, for CPU runs of the whole harness.

Three loci of two allele lengths, 20 alleles each, four 40 kb genomes
cut into 1-3 records (so that records fall on both sides of the 10 kb
split), every second genome carrying a profile the table lacks.  The
port picks the stated layout at these sizes too (h = 1, P = 1).
"""

import time

from bench_port import harness

CELL = "mlst7-genomes"
CONFIG = {"loci": {"Oxf_cpn60": 180, "Oxf_gdhB": 150, "Oxf_gltA": 180}, "alleles_per_locus": 20,
          "profiles": 30, "novel_every": 2, "num_genomes": 4, "genome_bp": 40_000}
TRAFFIC = {"contigs": [1, 3], "pool_files": 4, "sample_files": 3}
SEED = 2**31 + 23


def plan() -> dict:
    return harness.load_plan(CELL, overrides={"config": CONFIG, "traffic": TRAFFIC})


def run(seconds: float = 0.5, trace: bool = False, seed: int = SEED, tmp_path=None) -> dict:
    """One run of the tiny cell on the CPU, past the harness's look for a card."""
    return harness.run_cell(plan(), seed, seconds, trace, "cpu", time.time(), work_root=tmp_path)
