"""SVM species head: a fitted one-vs-one SVC evaluated with PyTorch.

The JAX package fits an ``sklearn.svm.SVC`` on ``scores.csv`` and
predicts with sklearn in float64.  :class:`SVMHead` carries the fitted
parameters onto the device and reproduces libsvm's one-vs-one voting in
float64, so a score vector near a decision boundary votes as sklearn's
does.  Its matrix products are plain ``torch.matmul``: the head is a
few small dense products and has no kernel of its own.
"""

import numpy as np
import torch
from torch import nn


def fit_svc(x_train, y_train, kernel: str, c: float):
    """Fit an SVC as the JAX package does (default gamma='scale')."""
    from sklearn.svm import SVC

    svm = SVC(kernel=kernel, C=c)
    svm.fit(x_train, y_train)
    return svm


class SVMHead(nn.Module):
    """One-vs-one SVC decision head.

    For each class pair (i, j), i < j in ``classes`` order, the pair's
    decision value votes for i if positive, else for j; the predicted
    class is the first one with the most votes (libsvm's tie rule).
    """

    def __init__(
        self,
        support_vectors,
        dual_coef,
        intercept,
        n_support,
        classes,
        kernel: str,
        gamma: float,
        degree: int = 3,
        coef0: float = 0.0,
    ):
        super().__init__()
        if kernel not in ("linear", "rbf", "poly", "sigmoid"):
            raise ValueError(f"Unsupported kernel {kernel}")
        f64 = torch.float64
        self.register_buffer("support_vectors", torch.as_tensor(np.asarray(support_vectors), dtype=f64))
        self.register_buffer("dual_coef", torch.as_tensor(np.asarray(dual_coef), dtype=f64))
        self.register_buffer("intercept", torch.as_tensor(np.asarray(intercept), dtype=f64))
        self.n_support = [int(v) for v in np.asarray(n_support)]
        self.classes = list(classes)
        self.kernel = kernel
        self.gamma = float(gamma)
        self.degree = int(degree)
        self.coef0 = float(coef0)
        n_classes = len(self.classes)
        pairs = [(i, j) for i in range(n_classes) for j in range(i + 1, n_classes)]
        w_pos = torch.zeros((len(pairs), n_classes), dtype=f64)
        w_neg = torch.zeros((len(pairs), n_classes), dtype=f64)
        for p, (i, j) in enumerate(pairs):
            w_pos[p, i] = 1
            w_neg[p, j] = 1
        self.register_buffer("w_pos", w_pos)
        self.register_buffer("w_neg", w_neg)
        self.pairs = pairs

    @classmethod
    def from_sklearn(cls, svc) -> "SVMHead":
        return cls(
            support_vectors=svc.support_vectors_,
            dual_coef=svc._dual_coef_,
            intercept=svc._intercept_,
            n_support=svc.n_support_,
            classes=svc.classes_,
            kernel=svc.kernel,
            gamma=float(svc._gamma),
            degree=int(svc.degree),
            coef0=float(svc.coef0),
        )

    def _kernel_matrix(self, x: torch.Tensor) -> torch.Tensor:
        sv = self.support_vectors
        if self.kernel == "linear":
            return x @ sv.T
        if self.kernel == "rbf":
            d2 = (x**2).sum(dim=1)[:, None] + (sv**2).sum(dim=1)[None, :] - 2.0 * (x @ sv.T)
            return torch.exp(-self.gamma * d2)
        if self.kernel == "poly":
            return (self.gamma * (x @ sv.T) + self.coef0) ** self.degree
        return torch.tanh(self.gamma * (x @ sv.T) + self.coef0)

    def decision_values(self, x) -> torch.Tensor:
        """OvO decision values [n_samples, n_pairs] in libsvm pair order."""
        x = torch.as_tensor(x, dtype=torch.float64, device=self.support_vectors.device)
        km = self._kernel_matrix(x)
        starts = np.concatenate([[0], np.cumsum(self.n_support)])
        decisions = []
        for p, (i, j) in enumerate(self.pairs):
            si, ei = starts[i], starts[i + 1]
            sj, ej = starts[j], starts[j + 1]
            d = (
                km[:, si:ei] @ self.dual_coef[j - 1, si:ei]
                + km[:, sj:ej] @ self.dual_coef[i, sj:ej]
                + self.intercept[p]
            )
            decisions.append(d)
        return torch.stack(decisions, dim=1)

    def forward(self, x) -> torch.Tensor:
        """Predicted class indices (into ``classes``) per sample."""
        pos = (self.decision_values(x) > 0).to(torch.float64)
        votes = pos @ self.w_pos + (1 - pos) @ self.w_neg
        # torch.argmax returns the first maximal index, libsvm's tie rule
        return torch.argmax(votes, dim=1)

    def predict(self, x) -> list:
        return [self.classes[int(i)] for i in self(x).cpu()]
