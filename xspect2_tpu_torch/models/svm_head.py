"""SVM species head: a fitted one-vs-one SVC evaluated on the card.

The JAX package fits an ``sklearn.svm.SVC`` on ``scores.csv`` and
predicts with sklearn in float64.  The port does not depend on sklearn:
:func:`fit_ovo_svc` fits the same machine with libsvm's solver written
out in numpy, and :class:`SVMHead` carries the fitted parameters onto
the device and reproduces libsvm's one-vs-one voting in float64.  On a
CUDA tensor a prediction is one launch of kernel K11
(:func:`xspect2_tpu_torch.ops.svm_head.svm_head`, ``csrc/svm_head.cu``):
kernel row, every pair's decision, votes and the first class with the
most votes, through the head's launch plan, made at its first call on
the card and dropped when its buffers move.  On the CPU the head runs
K11's plain version, a few dense products over a coefficient matrix per
side of the pair, the same few ops however many pairs there are.
"""

import math

import numpy as np
import torch
from torch import nn

from xspect2_tpu_torch.ops.svm_head import svm_head

# libsvm's stand-in for a non-positive quadratic coefficient
_TAU = 1e-12


def _powi(base: float, times: int) -> float:
    """libsvm's ``powi``: ``base ** times`` by repeated squaring."""
    tmp, ret = base, 1.0
    while times > 0:
        if times % 2 == 1:
            ret *= tmp
        tmp = tmp * tmp
        times //= 2
    return ret


def _kernel(x: np.ndarray, kernel: str, gamma: float, degree: int = 3,
            coef0: float = 0.0) -> np.ndarray:
    """libsvm's training kernel over the float64 rows of ``x``: [n, n].

    Each entry is computed as libsvm computes it, with a BLAS ``ddot``
    per pair and the C library's ``exp``/``tanh``, so the matrix equals
    libsvm's bit for bit (a matrix product rounds differently, and the
    solver's choices at ties follow the last bit).
    """
    if kernel not in ("linear", "rbf", "poly", "sigmoid"):
        raise ValueError(f"Unsupported kernel {kernel}")
    n = len(x)
    rows = [np.ascontiguousarray(r) for r in x]
    square = [float(np.dot(r, r)) for r in rows]
    k = np.empty((n, n))
    for i in range(n):
        for j in range(i, n):
            dot = float(np.dot(rows[i], rows[j]))
            if kernel == "linear":
                v = dot
            elif kernel == "rbf":
                v = math.exp(-gamma * (square[i] + square[j] - 2 * dot))
            elif kernel == "poly":
                v = _powi(gamma * dot + coef0, degree)
            else:
                v = math.tanh(gamma * dot + coef0)
            k[i, j] = k[j, i] = v
    return k


def _solve_binary(k: np.ndarray, y: np.ndarray, c: float, eps: float = 1e-3):
    """libsvm's ``Solver::Solve`` for one C-SVC dual, step for step.

    Minimizes ``a^T Q a / 2 - sum(a)`` over ``0 <= a <= c``, ``y^T a =
    0``, with ``Q = y y^T * k`` held in float32 as libsvm holds it:
    second-order working-set selection (ties go to the last index of the
    active set), shrinking every ``min(l, 1000)`` iterations with
    libsvm's index swaps, gradient reconstruction and rho, so that alpha
    and rho equal libsvm's bit for bit.  Returns ``(alpha, rho)``.
    """
    l = len(y)
    y = y.astype(np.float64)
    q = (np.outer(y, y) * k).astype(np.float32).astype(np.float64)
    qd = np.diag(k).copy()
    alpha = np.zeros(l)
    grad = -np.ones(l)  # p = -1
    g_bar = np.zeros(l)  # sum of c * Q[:, j] over j at the upper bound
    active = np.arange(l)  # libsvm's active_set: position -> sample
    size = l
    unshrink = False

    def swap(i, j):
        for a in (y, grad, alpha, active, g_bar, qd):
            a[[i, j]] = a[[j, i]]
        q[[i, j]] = q[[j, i]]
        q[:, [i, j]] = q[:, [j, i]]

    def last(mask_values, pick):
        """Last position of ``pick`` (max or min) among ``mask_values``."""
        rev = mask_values[::-1]
        return len(rev) - 1 - int(pick(rev))

    def in_sets(n):
        up, low = alpha[:n] >= c, alpha[:n] <= 0
        pos = y[:n] > 0
        return np.where(pos, ~up, ~low), np.where(pos, ~low, ~up)

    def select():
        in_up, in_low = in_sets(size)
        yg = y[:size] * grad[:size]
        if not in_up.any():
            return None
        vals = np.where(in_up, -yg, -np.inf)
        i = last(vals, np.argmax)
        gmax = vals[i]
        gmax2 = yg[in_low].max() if in_low.any() else -np.inf
        diff = gmax + yg
        quad = qd[i] + qd[:size] - 2.0 * y[i] * y[:size] * q[i, :size]
        obj = -(diff * diff) / np.where(quad > 0, quad, _TAU)
        cand = in_low & (diff > 0)
        if gmax + gmax2 < eps or not cand.any():
            return None
        return i, last(np.where(cand, obj, np.inf), np.argmin)

    def reconstruct():
        if size == l:
            return
        grad[size:] = g_bar[size:] - 1.0
        free = (alpha[:size] > 0) & (alpha[:size] < c)
        for j in np.nonzero(free)[0]:
            grad[size:] += alpha[j] * q[size:, j]

    def shrink():
        nonlocal size, unshrink
        in_up, in_low = in_sets(size)
        yg = y[:size] * grad[:size]
        gmax1 = (-yg[in_up]).max() if in_up.any() else -np.inf
        gmax2 = yg[in_low].max() if in_low.any() else -np.inf
        if not unshrink and gmax1 + gmax2 <= eps * 10:
            unshrink = True
            reconstruct()
            size = l

        def be_shrunk(t):
            if alpha[t] >= c:
                return -grad[t] > (gmax1 if y[t] > 0 else gmax2)
            if alpha[t] <= 0:
                return grad[t] > (gmax2 if y[t] > 0 else gmax1)
            return False

        t = 0
        while t < size:
            if be_shrunk(t):
                size -= 1
                while size > t:
                    if not be_shrunk(size):
                        swap(t, size)
                        break
                    size -= 1
            t += 1

    counter = min(l, 1000) + 1
    while True:
        counter -= 1
        if counter == 0:
            counter = min(l, 1000)
            shrink()
        pair = select()
        if pair is None:
            reconstruct()
            size = l
            pair = select()
            if pair is None:
                break
            counter = 1
        i, j = pair

        old_i, old_j = alpha[i], alpha[j]
        if y[i] != y[j]:
            quad_ij = qd[i] + qd[j] + 2 * q[i, j]
            delta = (-grad[i] - grad[j]) / (quad_ij if quad_ij > 0 else _TAU)
            d = alpha[i] - alpha[j]
            alpha[i] += delta
            alpha[j] += delta
            if d > 0:
                if alpha[j] < 0:
                    alpha[j], alpha[i] = 0.0, d
            elif alpha[i] < 0:
                alpha[i], alpha[j] = 0.0, -d
            if d > 0:  # C_i - C_j == 0
                if alpha[i] > c:
                    alpha[i], alpha[j] = c, c - d
            elif alpha[j] > c:
                alpha[j], alpha[i] = c, c + d
        else:
            quad_ij = qd[i] + qd[j] - 2 * q[i, j]
            delta = (grad[i] - grad[j]) / (quad_ij if quad_ij > 0 else _TAU)
            s = alpha[i] + alpha[j]
            alpha[i] -= delta
            alpha[j] += delta
            if s > c:
                if alpha[i] > c:
                    alpha[i], alpha[j] = c, s - c
            elif alpha[j] < 0:
                alpha[j], alpha[i] = 0.0, s
            if s > c:
                if alpha[j] > c:
                    alpha[j], alpha[i] = c, s - c
            elif alpha[i] < 0:
                alpha[i], alpha[j] = 0.0, s
        grad[:size] += q[i, :size] * (alpha[i] - old_i) + q[j, :size] * (alpha[j] - old_j)
        for t, old in ((i, old_i), (j, old_j)):
            if (old >= c) != (alpha[t] >= c):
                g_bar[:] = g_bar - c * q[t] if old >= c else g_bar + c * q[t]

    # libsvm's calculate_rho, summing the free gradients in active-set order
    yg = y * grad
    upper, lower = alpha >= c, alpha <= 0
    free = ~upper & ~lower
    out = np.empty(l)
    out[active] = alpha
    if free.any():
        total = 0.0
        for v in yg[free].tolist():
            total += v
        return out, total / int(free.sum())
    ub_mask = (upper & (y < 0)) | (lower & (y > 0))
    lb_mask = (upper & (y > 0)) | (lower & (y < 0))
    ub = yg[ub_mask].min() if ub_mask.any() else np.inf
    lb = yg[lb_mask].max() if lb_mask.any() else -np.inf
    return out, float((ub + lb) / 2)


def fit_ovo_svc(x_train, y_train, kernel: str, c: float) -> "SVMHead":
    """A one-vs-one C-SVC fitted as libsvm fits it, as an :class:`SVMHead`.

    Classes sorted, gamma='scale', one binary problem per class pair
    (i, j), i < j, with class i as +1, each solved by
    :func:`_solve_binary` on libsvm's own kernel values.  The support
    vectors, dual coefficients and intercepts equal those of sklearn's
    ``SVC(kernel=kernel, C=c)`` bit for bit where both use the same
    BLAS ``ddot``.  The head's decision values are computed in another
    order than libsvm's, so only a score vector that lies exactly on a
    decision boundary (a tie between two classes) can vote otherwise.
    """
    x = np.asarray(x_train, dtype=np.float64)
    y = np.asarray(y_train)
    classes = np.unique(y)
    var = x.var()
    gamma = 1.0 / (x.shape[1] * var) if var != 0 else 1.0
    k = _kernel(x, kernel, gamma)
    members = [np.nonzero(y == cls)[0] for cls in classes]
    n_cls = len(classes)
    coef = {}  # (pair i, j) -> (sample indices, y * alpha)
    is_sv = np.zeros(len(y), dtype=bool)
    intercept = []
    for i in range(n_cls):
        for j in range(i + 1, n_cls):
            idx = np.concatenate([members[i], members[j]])
            yb = np.concatenate([np.ones(len(members[i])), -np.ones(len(members[j]))])
            alpha, rho = _solve_binary(k[np.ix_(idx, idx)], yb, c)
            coef[i, j] = (idx, yb * alpha)
            is_sv[idx[alpha > 0]] = True
            intercept.append(-rho if rho != 0 else 0.0)
    sv_of = [m[is_sv[m]] for m in members]
    order = np.concatenate(sv_of)
    column = {int(s): col for col, s in enumerate(order)}
    dual = np.zeros((n_cls - 1, len(order)))
    for (i, j), (idx, cf) in coef.items():
        for s, v in zip(idx, cf):
            if is_sv[s]:
                row = j - 1 if y[s] == classes[i] else i
                dual[row, column[int(s)]] = v
    return SVMHead(
        support_vectors=x[order], dual_coef=dual, intercept=np.array(intercept),
        n_support=[len(s) for s in sv_of], classes=list(classes), kernel=kernel, gamma=gamma,
    )


class SVMHead(nn.Module):
    """One-vs-one SVC decision head.

    For each class pair (i, j), i < j in ``classes`` order, the pair's
    decision value votes for i if positive, else for j; the predicted
    class is the first one with the most votes (libsvm's tie rule).
    ``SVMHead.calls`` counts the predictions made, over all heads.

    The pair (i, j) at column p sums class i's support vectors against
    ``dual_coef[j - 1]`` and class j's against ``dual_coef[i]``.  Each
    class's first support vector (the int32 buffer ``starts``) and the
    support vectors' squared norms (``sv_sq``) are made once here.  K11
    reads the head from its launch plan (``k11_plan``,
    :class:`~xspect2_tpu_torch.ops.svm_head.LaunchPlan`): these arrays,
    the coefficients pair by pair and a pair table, packed once on the
    card at the first call there; :meth:`_apply` (``.to()``, ``.cuda()``)
    and :meth:`_load_from_state_dict` drop it, so that no launch reads
    stale buffers.  The plain version reads the float64
    buffer ``coef`` ([n_sv, n_pairs]), which holds those coefficients in
    column p, in the rows of class i's and class j's segment, and zeros
    elsewhere, so that the decisions of every pair are
    ``km @ coef + intercept``, one accumulator over both segments as
    libsvm sums them: a zero coefficient adds an exact zero.
    """

    calls = 0
    k11_plan = None

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
        for name, value in (("support_vectors", support_vectors), ("dual_coef", dual_coef),
                            ("intercept", intercept)):
            self.register_buffer(name, torch.as_tensor(np.ascontiguousarray(value), dtype=f64))
        self.register_buffer("sv_sq", (self.support_vectors**2).sum(dim=1))
        self.n_support = [int(v) for v in np.asarray(n_support)]
        starts = np.concatenate([[0], np.cumsum(self.n_support)]).astype(np.int32)
        self.register_buffer("starts", torch.from_numpy(starts))
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
        dual = np.asarray(dual_coef, dtype=np.float64)
        owner = np.repeat(np.arange(n_classes), self.n_support)[:, None]  # each SV's class
        first = np.array([i for i, _ in pairs], dtype=np.int64)
        second = np.array([j for _, j in pairs], dtype=np.int64)
        coef = np.where(owner == first, dual[second - 1].T, np.where(owner == second, dual[first].T, 0.0))
        self.register_buffer("coef", torch.as_tensor(coef, dtype=f64))

    def _apply(self, fn, *args, **kwargs):
        self.k11_plan = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self.k11_plan = None
        return super()._load_from_state_dict(*args, **kwargs)

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

    def _rows(self, x) -> torch.Tensor:
        """``x`` as a float32 or float64 tensor on the head's device (a
        list or array of Python floats as float64)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.dtype not in (torch.float32, torch.float64):
            x = x.to(torch.float64)
        return x.to(self.support_vectors.device)

    def decision_values(self, x) -> torch.Tensor:
        """OvO decision values [n_samples, n_pairs] in libsvm pair order."""
        return svm_head(self, self._rows(x), predict=False, decisions=True)[1]

    def predict_indices(self, x) -> torch.Tensor:
        """Predicted class indices (into ``classes``) per sample, as a
        tensor on the head's device: nothing is fetched to the host, so a
        step that scores on the device stays there.  ``x`` may be float32
        scores; the decision values are computed in float64."""
        SVMHead.calls += 1
        return svm_head(self, self._rows(x))[0]

    def forward(self, x) -> torch.Tensor:
        """:meth:`predict_indices`."""
        return self.predict_indices(x)

    def predict(self, x) -> list:
        return [self.classes[int(i)] for i in self(x).cpu()]
