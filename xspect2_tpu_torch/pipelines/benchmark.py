"""Benchmark pipelines: assembly-level and read-level evaluation.

The metrics of the JAX package's ``xspect2_tpu.pipelines.benchmark``:

- per-sample prediction = the model's SVM prediction when present, else
  the unique argmax of total hits, with ties labeled ``"ambiguous"``;
- assembly stats: accuracy, macro/weighted F1;
- read stats additionally: coverage (non-rejected fraction), selective
  accuracy/risk on non-rejected reads, rejection precision/recall
  against truly misclassified reads.

:func:`run_read_benchmark` counts through the engine's read query
(K1 + K2 on the card); :func:`run_assembly_benchmark` through the
model's ``predict`` (the records route: K4 + K3, or K4 + K7 for an xxh3
genus model).  Both take ``device`` (``None`` means CUDA), the device
the model must have been loaded on.
"""

import csv
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from xspect2_tpu_torch import resolve_device


# ---------------------------------------------------------------------- stats


def _f1_stats(y_true: list[str], y_pred: list[str]) -> dict:
    """accuracy + macro/weighted F1 over the true-label class set."""
    classes = sorted(set(y_true))
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    f1s, weights = [], []
    for c in classes:
        tp = float(((y_pred == c) & (y_true == c)).sum())
        fp = float(((y_pred == c) & (y_true != c)).sum())
        fn = float(((y_pred != c) & (y_true == c)).sum())
        f1 = 2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0
        f1s.append(f1)
        weights.append(float((y_true == c).sum()))
    weights = np.asarray(weights)
    return {
        "total": len(y_true),
        "matches": int((y_true == y_pred).sum()),
        "mismatches": int((y_true != y_pred).sum()),
        "accuracy": float((y_true == y_pred).mean()) if len(y_true) else 0.0,
        "macro_f1": float(np.mean(f1s)) if f1s else 0.0,
        "weighted_f1": float((np.asarray(f1s) * weights).sum() / weights.sum())
        if weights.sum()
        else 0.0,
    }


def _argmax_or_ambiguous(total_hits: dict[str, int]) -> str:
    """Unique argmax of total hits; ties -> 'ambiguous'."""
    if not total_hits:
        return "ambiguous"
    max_hits = max(total_hits.values())
    winners = [s for s, h in total_hits.items() if h == max_hits]
    return winners[0] if len(winners) == 1 else "ambiguous"


def evaluate_assembly_classifications(
    rows: list[tuple[str, str, str]],
) -> dict:
    """Stats over (sample_id, true_label, predicted_label) rows."""
    y_true = [r[1] for r in rows]
    y_pred = [r[2] for r in rows]
    return _f1_stats(y_true, y_pred)


def evaluate_read_classifications(
    rows: list[tuple[str, str, str]],
) -> dict:
    """Read-level stats with rejection metrics.

    rows = (read_id, true_label, predicted_label_or_'ambiguous').
    """
    return evaluate_read_labels(
        [r[1] for r in rows], [r[2] for r in rows]
    )


def evaluate_read_labels(y_true, y_pred) -> dict:
    """Array form of :func:`evaluate_read_classifications`.

    ``y_true``/``y_pred`` are label sequences ('ambiguous' marks a
    rejected read); the row-tuple wrapper above delegates here so
    million-read benchmarks skip building per-read tuples.
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    stats = _f1_stats(list(y_true), list(y_pred))

    rejected = y_pred == "ambiguous"
    not_rejected = ~rejected
    # a read is "actually misclassified" if a definite prediction would be
    # wrong; ambiguous reads count as misclassified for recall purposes
    actually_mis = y_pred != y_true

    coverage = float(not_rejected.mean()) if len(y_true) else 0.0
    if not_rejected.sum():
        selective_accuracy = float(
            ((y_true == y_pred) & not_rejected).sum() / not_rejected.sum()
        )
    else:
        selective_accuracy = 0.0
    rejection_precision = (
        float((rejected & actually_mis).sum() / rejected.sum())
        if rejected.sum()
        else 0.0
    )
    rejection_recall = (
        float((rejected & actually_mis).sum() / actually_mis.sum())
        if actually_mis.sum()
        else 0.0
    )
    stats.update(
        {
            "coverage": coverage,
            "selective_accuracy": selective_accuracy,
            "selective_risk": 1.0 - selective_accuracy,
            "rejection_precision": rejection_precision,
            "rejection_recall": rejection_recall,
        }
    )
    return stats


# ------------------------------------------------------------------ pipelines


def _check_device(model, device) -> None:
    """Resolve the benchmark's device and require the model to be on it."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"the model is on {model.device}, the benchmark runs on {device}")


@dataclass
class BenchmarkResult:
    rows: list[tuple[str, str, str]]
    stats: dict
    per_sample_scores: dict[str, dict] = field(default_factory=dict)

    def save(self, out_dir: Path) -> None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "classifications.tsv", "w", newline="") as f:
            w = csv.writer(f, delimiter="\t")
            w.writerow(["sample", "true_label", "prediction"])
            w.writerows(self.rows)
        (out_dir / "stats.json").write_text(json.dumps(self.stats, indent=2))


def run_assembly_benchmark(
    model,
    samples: list[tuple[Path, str]],
    step: int = 1,
    out_dir: Path | None = None,
    device=None,
) -> BenchmarkResult:
    """Classify assembly files against their true labels.

    ``samples`` = list of (fasta_path, true_label).  Uses the model's SVM
    prediction when available, else unique-argmax with tie rejection.
    """
    _check_device(model, device)
    rows = []
    scores = {}
    for path, true_label in samples:
        res = model.predict(path, step=step)
        if res.prediction is not None:
            pred = str(res.prediction)
        else:
            pred = _argmax_or_ambiguous(res.get_total_hits())
        rows.append((path.name, true_label, pred))
        scores[path.name] = res.get_scores()["total"]

    result = BenchmarkResult(rows, evaluate_assembly_classifications(rows), scores)
    if out_dir is not None:
        result.save(out_dir)
    return result


def run_read_benchmark(
    model,
    reads: np.ndarray,
    true_labels: list[str],
    step: int = 1,
    batch_reads: int = 65536,
    out_dir: Path | None = None,
    device=None,
) -> BenchmarkResult:
    """Per-read classification benchmark on a [N, L] uint8 code matrix.

    Streams through the engine's read query; per-read prediction is the
    unique hit-count argmax with ties rejected as 'ambiguous'.
    """
    _check_device(model, device)
    engine = model.engine
    class_names = model.index.class_names
    rows = []
    n = len(reads)
    for start in range(0, n, batch_reads):
        chunk = reads[start : start + batch_reads]
        hits = engine.count_hits_reads(chunk, step=step)
        max_hits = hits.max(axis=1)
        argmax = hits.argmax(axis=1)
        tie = (hits == max_hits[:, None]).sum(axis=1) > 1
        for i in range(len(chunk)):
            pred = "ambiguous" if tie[i] else class_names[int(argmax[i])]
            rows.append((f"read{start + i}", true_labels[start + i], pred))

    result = BenchmarkResult(rows, evaluate_read_classifications(rows))
    if out_dir is not None:
        result.save(out_dir)
    return result
