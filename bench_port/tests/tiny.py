"""Tiny sizes of every cell, for CPU runs of the whole harness.

The port runs its kernels' plain versions on the CPU, so a cell's run
here checks the harness, the reference and the check, never a time.
The index geometry is stated as the port picks it at these sizes
(two hashes; P = 8 at three classes, 32 at one).
"""

import json
import time

from bench_port import harness

SPECIES = {"num_classes": 3, "genome_bp": 30_000, "svm_genome_bp": 8_000, "svm_contigs": [2, 5],
           "num_hashes": 2, "fields_per_word": 8, "class_words": 1}
GENUS = {"num_genomes": 3, "genome_bp": 30_000, "num_hashes": 2, "fields_per_word": 32}
READS = {"reads_per_file": 600, "pool_files": 2}
ASSEMBLIES = {"contigs": [5, 20], "pool_files": 4, "sample_files": 2}

TINY = {
    "species40-reads": {"config": SPECIES, "traffic": READS},
    "species40-assemblies": {"config": SPECIES, "traffic": ASSEMBLIES},
    "genus160-reads": {"config": GENUS, "traffic": READS},
    "genus160-assemblies": {"config": GENUS, "traffic": ASSEMBLIES},
}
CELLS = list(TINY)
SEED = 2**31 + 11
# out of BENCHMARK.json, since its rate spreads past the widest bound the
# format allows (PERF.md, Open questions); its route (reads through the
# species facade and the SVM head) stays tested as the cell stood, with
# the reads metrics of genus160-reads
HELD_OUT = {"name": "species40-reads", "config": "species40-svm", "traffic": "reads-20k", "chips": 1,
            "why": "FASTQ files of 20,000 150 bp reads of one isolate through classify_species"}


def spec() -> dict:
    """``BENCHMARK.json``, with the held-out cell where it is missing."""
    body = json.loads((harness.ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
    if all(w["name"] != HELD_OUT["name"] for w in body["workloads"]):
        body["workloads"].append(dict(HELD_OUT))
        for m in body["end_to_end"] + body["per_layer"]:
            if "genus160-reads" in m.get("workloads", ()):
                m["workloads"].append(HELD_OUT["name"])
    return body


def plan(cell: str) -> dict:
    return harness.load_plan(cell, spec=spec(), overrides=TINY[cell])


def run(cell: str, seconds: float = 0.5, trace: bool = False, seed: int = SEED, tmp_path=None) -> dict:
    """One run of the tiny cell on the CPU, past the harness's look for a card."""
    return harness.run_cell(plan(cell), seed, seconds, trace, "cpu", time.time(), work_root=tmp_path)
