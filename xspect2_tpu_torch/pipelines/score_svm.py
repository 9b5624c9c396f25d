"""SVM hyper-parameter evaluation over scores.csv: a leave-one-out grid
search over the kernels and C values of the species model's SVC.

Each fold is fitted by :func:`~xspect2_tpu_torch.models.svm_head.fit_ovo_svc`
(libsvm's solver, equal to sklearn's ``SVC`` fit) and predicts its
held-out row with the fitted :class:`~xspect2_tpu_torch.models.svm_head.SVMHead`
on ``device``.
"""

from itertools import product

import numpy as np

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.models.svm_head import fit_ovo_svc


def grid_search_svm(
    x: np.ndarray,
    y: list[str],
    kernels: tuple[str, ...] = ("linear", "rbf", "poly", "sigmoid"),
    cs: tuple[float, ...] = (0.1, 1.0, 10.0),
    device=None,
) -> list[dict]:
    """Leave-one-out accuracy for each (kernel, C); best first."""
    device = resolve_device(device)
    x = np.asarray(x, dtype=float)
    y = np.asarray(y)
    n = len(y)
    results = []
    for kernel, c in product(kernels, cs):
        correct = 0
        for i in range(n):
            mask = np.arange(n) != i
            if len(set(y[mask])) < 2:
                continue
            head = fit_ovo_svc(x[mask], y[mask], kernel, c).to(device)
            correct += int(head.predict(x[i : i + 1])[0] == y[i])
        results.append(
            {"kernel": kernel, "C": c, "loo_accuracy": correct / n if n else 0.0}
        )
    results.sort(key=lambda r: -r["loo_accuracy"])
    return results


def grid_search_model(model, kernels=("linear", "rbf"), cs=(0.1, 1.0, 10.0), device=None):
    """Grid search over a trained SVM model's persisted scores.csv."""
    device = resolve_device(device)
    x, y = model._read_training_scores(None)
    return grid_search_svm(np.asarray(x), y, kernels=kernels, cs=cs, device=device)
