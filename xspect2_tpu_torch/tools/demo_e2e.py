#!/usr/bin/env python
"""End-to-end product demo on the port: train through the CLI, then run ``all``.

Builds a synthetic 3-species registry (an SVM species model and the
genus metagenome model) through the port's click CLI, classifies a mixed
read file through the full pipeline (genus filter -> species
classification -> conditional MLST), and asserts that the species
prediction is the dominant read source.  It is the counterpart of the
JAX package's ``tools/demo_e2e.py``, with the same seeds, registry and
reads, so at the same flags both write the same model files and
results; run it after engine changes to confirm that the shipped
product path works on the card, not just the kernels::

    python -m xspect2_tpu_torch.tools.demo_e2e [--genome-mb 2.0] [--reads 600] [--keep] [--device cuda]

It runs on the CUDA card; without one it raises unless ``--device cpu``
is given.  The registry lives in a temporary directory, removed at the
end unless ``--keep`` is given.
"""

import argparse
import importlib
import json
import os
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.io.fasta import SeqRecord, write_fasta


def _failure(result) -> str:
    """A failed command's output and, where it raised, its traceback."""
    if result.exc_info is None:
        return result.output
    return result.output + "".join(traceback.format_exception(*result.exc_info))


def main(argv=None) -> Path:
    """Run the demo; returns its temporary directory (removed unless ``--keep``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-mb", type=float, default=2.0)
    ap.add_argument("--reads", type=int, default=600)
    ap.add_argument("--keep", action="store_true", help="keep the tmp registry")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain PyTorch versions")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card: raise before anything is written

    tmp = Path(tempfile.mkdtemp(prefix="xs_demo_"))
    os.environ["XSPECT_DATA_ROOT"] = str(tmp)

    from click.testing import CliRunner

    rng = np.random.default_rng(5)
    bases = np.array(list("ACGT"))
    glen = int(args.genome_mb * 1e6)
    root = tmp / "train"
    genomes = {}
    for label in ("470", "471", "472"):
        g = "".join(rng.choice(bases, size=glen))
        genomes[label] = g
        (root / "cobs" / label).mkdir(parents=True)
        write_fasta([SeqRecord(g, label)], root / "cobs" / label / f"{label}.fasta")
        (root / "svm" / label).mkdir(parents=True)
        for i in range(2):  # noisy copies as SVM training genomes
            arr = np.frombuffer(g.encode(), dtype=np.uint8).copy()
            pos = rng.integers(0, len(arr), size=len(arr) // 200)
            arr[pos] = np.frombuffer(b"ACGT", dtype=np.uint8)[
                rng.integers(0, 4, size=len(pos))
            ]
            write_fasta(
                [SeqRecord(arr.tobytes().decode(), f"{label}_svm{i}")],
                root / "svm" / label / f"{label}_svm{i}.fasta",
            )

    reads = []
    for n, label in ((args.reads // 2, "470"), (args.reads // 3, "471")):
        g = genomes[label]
        for i in range(n):
            p = int(rng.integers(0, glen - 150))
            reads.append(SeqRecord(g[p : p + 150], f"{label}_r{i}"))
    for i in range(args.reads // 6):  # off-genus noise the filter drops
        reads.append(SeqRecord("".join(rng.choice(bases, size=150)), f"rand_{i}"))
    sample = tmp / "sample.fasta"
    write_fasta(reads, sample)

    import xspect2_tpu_torch.main as main_mod

    cli = main_mod.cli
    device = ["--device", args.device]
    runner = CliRunner()
    print("training (CLI: models train directory)...", flush=True)
    t0 = time.time()
    r = runner.invoke(
        cli, [*device, "models", "train", "directory", "-g", "Testus", "-i", str(root), "--meta"]
    )
    assert r.exit_code == 0, _failure(r)
    print(f"  trained in {time.time() - t0:.2f} s", flush=True)

    # the CLI derives -g choices from the registry at import time (as the
    # JAX CLI does); re-import so that the freshly trained model appears
    cli = importlib.reload(main_mod).cli
    out_dir = tmp / "out"
    print("running the full pipeline (CLI: all)...", flush=True)
    t0 = time.time()
    r = runner.invoke(
        cli,
        [*device, "all", "-g", "Testus", "-i", str(sample), "-o", str(out_dir), "-t", "0.5"],
    )
    print(r.output)
    assert r.exit_code == 0, _failure(r)
    print(f"  all in {time.time() - t0:.2f} s", flush=True)

    predictions = [
        json.load(f.open()).get("prediction")
        for f in sorted(out_dir.glob("species_classification*.json"))
    ]
    assert predictions and predictions[0] == "470", predictions
    print(f"OK: species prediction {predictions[0]} (dominant read source)")
    if not args.keep:
        shutil.rmtree(tmp, ignore_errors=True)
    return tmp


if __name__ == "__main__":
    main()
