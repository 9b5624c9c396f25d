"""Result objects.

``MlstResult`` wraps MLST hits as ``{Scheme, Steps, Results,
Input_source}``.  ``ModelResult`` is a copy of the JAX package's result class, so result
JSON comes out byte-identical: per-record hits, per-record k-mer
counts, scores = ``round(hits / num_kmers, 2)`` per record plus a
``"total"`` row over summed hits/kmers, threshold/argmax filter masks,
and the JSON schema
``{model_slug, sparse_sampling_step, hits, scores, num_kmers,
misclassified, input_source, prediction?}``.
"""

import json
from collections import Counter
from pathlib import Path

from xspect2_tpu_torch import profiling

#: sentinel filter threshold selecting per-record argmax instead of a cutoff
ARGMAX = -1

#: reserved record key for the aggregate score row
TOTAL_KEY = "total"

#: reserved hits key the misclassification post-filter writes its bucket to
MISCLASSIFIED_KEY = "misclassified"


def _score_row(hits_row: dict[str, int], num_kmers: int) -> dict[str, float]:
    """One record's scores: hits / k-mer count, rounded to 2 decimals."""
    return {label: round(count / num_kmers, 2) for label, count in hits_row.items()}


class ModelResult:
    """Per-record hit counts and derived scores for one classified input."""

    def __init__(
        self,
        model_slug: str,
        hits: dict[str, dict[str, int]],
        num_kmers: dict[str, int],
        sparse_sampling_step: int = 1,
        prediction: str | None = None,
        input_source: str | None = None,
    ):
        if TOTAL_KEY in hits:
            raise ValueError(
                f"{TOTAL_KEY!r} is a reserved key and cannot be used as a "
                "subsequence"
            )
        self.model_slug = model_slug
        self.hits = hits
        self.num_kmers = num_kmers
        self.sparse_sampling_step = sparse_sampling_step
        self.prediction = prediction
        self.input_source = input_source
        # the post-filter bucket is carried outside the per-record rows
        self.misclassified = self.hits.pop(MISCLASSIFIED_KEY, None)

    # ------------------------------------------------------------------ scores

    def get_total_hits(self) -> dict[str, int]:
        """Sum hits per label across all records (label order of the first)."""
        totals: Counter = Counter()
        for row in self.hits.values():
            totals.update(row)
        first_row = next(iter(self.hits.values()))
        return {label: totals[label] for label in first_row}

    def get_scores(self) -> dict:
        """Scores per record plus the aggregate ``"total"`` row."""
        scores = {
            record: _score_row(row, self.num_kmers[record])
            for record, row in self.hits.items()
        }
        scores[TOTAL_KEY] = _score_row(
            self.get_total_hits(), sum(self.num_kmers.values())
        )
        return scores

    # ------------------------------------------------------------------ filtering

    def get_filter_mask(self, label: str, filter_threshold: float) -> dict[str, bool]:
        """Per-record keep mask: score >= threshold, or per-record argmax
        when the threshold is the :data:`ARGMAX` sentinel."""
        valid = filter_threshold == ARGMAX or 0 <= filter_threshold <= 1
        if not valid:
            raise ValueError("The filter threshold must be between 0 and 1.")
        per_record = self.get_scores()
        per_record.pop(TOTAL_KEY)
        if filter_threshold == ARGMAX:
            return {
                record: row[label] == max(row.values())
                for record, row in per_record.items()
            }
        return {
            record: row[label] >= filter_threshold
            for record, row in per_record.items()
        }

    def get_filtered_subsequence_labels(
        self, label: str, filter_threshold: float = 0.7
    ) -> list[str]:
        """Record ids passing the filter mask."""
        mask = self.get_filter_mask(label, filter_threshold)
        return [record for record, keep in mask.items() if keep]

    # ------------------------------------------------------------------ serialization

    def to_dict(self) -> dict:
        payload = {
            "model_slug": self.model_slug,
            "sparse_sampling_step": self.sparse_sampling_step,
            "hits": self.hits,
            "scores": self.get_scores(),
            "num_kmers": self.num_kmers,
            "misclassified": self.misclassified,
            "input_source": self.input_source,
        }
        if self.prediction is not None:
            payload["prediction"] = self.prediction
        return payload

    @profiling.phase("result.save")
    def save(self, path: Path) -> None:
        """Write the result JSON: the phases ``result.write`` (the
        directory), ``result.scores``, ``result.encode`` and
        ``result.write`` (the file) under ``result.save``."""
        path = Path(path)
        with profiling.phase("result.write"):
            path.parent.mkdir(exist_ok=True, parents=True)
        with profiling.phase("result.scores"):
            payload = self.to_dict()
        with profiling.phase("result.encode"):
            text = json.dumps(payload, indent=4)
        with profiling.phase("result.write"):
            path.write_text(text, encoding="utf-8")


class MlstResult:
    """MLST result wrapper: {Scheme, Steps, Results, Input_source}."""

    def __init__(
        self,
        scheme: str,
        steps: int,
        hits: dict[str, list[dict]],
        input_source: str | None = None,
    ):
        self.scheme = scheme
        self.steps = steps
        self.hits = hits
        self.input_source = input_source

    def get_results(self) -> dict:
        return self.hits

    def to_dict(self) -> dict:
        return {
            "Scheme": self.scheme,
            "Steps": self.steps,
            "Results": self.get_results(),
            "Input_source": self.input_source,
        }

    @profiling.phase("result.save")
    def save(self, output_path: Path | str) -> None:
        """Write the result JSON: the phases ``result.write`` (the
        directory), ``result.encode`` and ``result.write`` (the file)
        under ``result.save``."""
        output_path = Path(output_path)
        with profiling.phase("result.write"):
            output_path.parent.mkdir(exist_ok=True, parents=True)
        with profiling.phase("result.encode"):
            text = json.dumps(self.to_dict(), indent=4)
        with profiling.phase("result.write"):
            output_path.write_text(text, encoding="utf-8")
