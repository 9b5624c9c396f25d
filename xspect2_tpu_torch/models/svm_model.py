"""SVM-headed species model, read-classification path.

The filter model's per-class score totals feed an SVC fitted with
sklearn on the model's ``scores.csv``, as in the JAX package; the fitted
machine is carried into :class:`~xspect2_tpu_torch.models.svm_head.SVMHead`
and predicts on the model's device.  ``exclude_ids`` removes both
feature columns and label rows.
"""

import csv
from pathlib import Path

from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel
from xspect2_tpu_torch.models.result import ModelResult
from xspect2_tpu_torch.models.svm_head import SVMHead, fit_svc


class _ConstantPredictor:
    """Degenerate SVM stand-in when exclusion leaves a single class."""

    def __init__(self, label: str):
        self.label = label

    def predict(self, x):
        return [self.label] * len(x)


class ProbabilisticFilterSVMModel(ProbabilisticFilterModel):
    """Filter model with an SVM species-prediction head."""

    def __init__(
        self,
        k: int,
        model_display_name: str,
        author: str | None,
        author_email: str | None,
        model_type: str,
        base_path: Path,
        kernel: str,
        c: float,
        fpr: float = 0.01,
        num_hashes: int | None = None,
        training_accessions: dict[str, list[str]] | None = None,
        svm_accessions: dict[str, list[str]] | None = None,
        device=None,
    ) -> None:
        super().__init__(
            k=k,
            model_display_name=model_display_name,
            author=author,
            author_email=author_email,
            model_type=model_type,
            base_path=base_path,
            fpr=fpr,
            num_hashes=num_hashes,
            training_accessions=training_accessions,
            device=device,
        )
        self.kernel = kernel
        self.c = c
        self.svm_accessions = svm_accessions
        self._svm_cache: dict[tuple, object] = {}

    def to_dict(self) -> dict:
        return super().to_dict() | {
            "kernel": self.kernel,
            "C": self.c,
            "svm_accessions": self.svm_accessions,
        }

    # ------------------------------------------------------------------ inference

    def predict(
        self,
        sequence_input,
        exclude_ids: list[str] | None = None,
        step: int = 1,
        display_name: bool = False,
        validation: bool = False,
    ) -> ModelResult:
        res = super().predict(sequence_input, exclude_ids, step, display_name, validation)
        svm_scores = dict(sorted(res.get_scores()["total"].items()))
        x = [list(svm_scores.values())]
        res.hits["misclassified"] = res.misclassified
        return ModelResult(
            self.slug(),
            res.hits,
            res.num_kmers,
            sparse_sampling_step=step,
            prediction=str(self._get_svm(exclude_ids).predict(x)[0]),
        )

    def _read_training_scores(self, exclude_ids):
        """Parse scores.csv with exclude filtering (columns and label rows)."""
        x_train, y_train = [], []
        keys = sorted(self.display_names.keys())
        remove_indices = {
            i for i, key in enumerate(keys) if exclude_ids is not None and key in exclude_ids
        }
        csv_path = self.base_path / self.slug() / "scores.csv"
        with open(csv_path, "r", encoding="utf-8") as file:
            file.readline()  # header
            for row in csv.reader(file):
                if not row:
                    continue
                label = row[-1]
                if exclude_ids is not None and label in exclude_ids:
                    continue
                features = [
                    float(v) for i, v in enumerate(row[1:-1]) if i not in remove_indices
                ]
                x_train.append(features)
                y_train.append(label)
        return x_train, y_train

    def _get_svm(self, exclude_ids):
        """The SVM head for the given exclude set (fitted once, cached)."""
        key = tuple(sorted(exclude_ids)) if exclude_ids else ()
        if key not in self._svm_cache:
            x_train, y_train = self._read_training_scores(exclude_ids)
            if len(set(y_train)) == 1:
                self._svm_cache[key] = _ConstantPredictor(y_train[0])
            else:
                svc = fit_svc(x_train, y_train, self.kernel, self.c)
                self._svm_cache[key] = SVMHead.from_sklearn(svc).to(self.device)
        return self._svm_cache[key]

    # ------------------------------------------------------------------ persistence

    # metadata key -> constructor kwarg ("C" is the one key whose casing
    # differs from the kwarg)
    _METADATA_KWARGS = {
        "k": "k",
        "model_display_name": "model_display_name",
        "author": "author",
        "author_email": "author_email",
        "model_type": "model_type",
        "kernel": "kernel",
        "C": "c",
        "fpr": "fpr",
        "num_hashes": "num_hashes",
        "training_accessions": "training_accessions",
        "svm_accessions": "svm_accessions",
    }

    @classmethod
    def _from_metadata(cls, model_json: dict, base_path: Path, device):
        kwargs = {kw: model_json[key] for key, kw in cls._METADATA_KWARGS.items()}
        return cls(base_path=base_path, device=device, **kwargs)
