"""The species head's reference: libsvm's one-vs-one C-SVC in numpy.

A frozen copy of ``_powi``, ``_kernel``, ``_solve_binary`` and
``fit_ovo_svc`` of ``xspect2_tpu_torch/models/svm_head.py`` (libsvm's
solver step for step, equal to sklearn's ``SVC`` fit bit for bit), so
that the reference fits the machine itself from its own training
scores.  :class:`OvoSVC` predicts as libsvm's ``svm_predict`` does, in
float64 (or, for the control, in float32), with no kernel of the port.
"""

import math
from dataclasses import dataclass

import numpy as np

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


def fit_ovo_svc(x_train, y_train, kernel: str, c: float) -> "OvoSVC":
    """A one-vs-one C-SVC fitted as libsvm fits it, as an :class:`OvoSVC`.

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
    return OvoSVC(
        support_vectors=x[order], dual_coef=dual, intercept=np.array(intercept),
        n_support=[len(s) for s in sv_of], classes=list(classes), kernel=kernel, gamma=gamma,
    )


@dataclass
class OvoSVC:
    """A fitted one-vs-one SVC: libsvm's support vectors (class by class),
    dual coefficients [n_classes - 1, n_sv], intercepts (-rho) by pair."""

    support_vectors: np.ndarray
    dual_coef: np.ndarray
    intercept: np.ndarray
    n_support: list
    classes: list
    kernel: str
    gamma: float

    def decisions(self, x, dtype=np.float64) -> np.ndarray:
        """Decision values [n, n_pairs] in libsvm's pair order, computed
        in ``dtype``: each pair sums class i's support vectors against
        ``dual_coef[j - 1]`` and class j's against ``dual_coef[i]``."""
        if self.kernel != "rbf":
            raise ValueError("the benchmark's configurations use the rbf kernel")
        x = np.asarray(x, dtype=dtype)
        sv = self.support_vectors.astype(dtype)
        dual = self.dual_coef.astype(dtype)
        gamma = dtype(self.gamma)
        sq = (sv * sv).sum(axis=1)
        kv = np.exp(-gamma * ((x * x).sum(axis=1)[:, None] + sq[None, :] - 2 * x @ sv.T))
        starts = np.concatenate([[0], np.cumsum(self.n_support)])
        n_cls = len(self.classes)
        out = []
        for i in range(n_cls):
            for j in range(i + 1, n_cls):
                si, sj = slice(starts[i], starts[i + 1]), slice(starts[j], starts[j + 1])
                out.append(kv[:, si] @ dual[j - 1, si] + kv[:, sj] @ dual[i, sj])
        return np.stack(out, axis=1) + self.intercept.astype(dtype)

    def predict(self, x, dtype=np.float64) -> list:
        """libsvm's vote: a positive decision votes for i, else for j; the
        first class with the most votes wins."""
        dec = self.decisions(x, dtype)
        n_cls = len(self.classes)
        votes = np.zeros((len(dec), n_cls), dtype=np.int64)
        p = 0
        for i in range(n_cls):
            for j in range(i + 1, n_cls):
                pos = dec[:, p] > 0
                votes[pos, i] += 1
                votes[~pos, j] += 1
                p += 1
        return [self.classes[int(v)] for v in votes.argmax(axis=1)]

    def possible_labels(self, x, tol: float = 1e-9) -> list:
        """The labels that could win when every pair whose float64 decision
        lies within ``tol`` of 0 (a tie of the scores, which a sum in
        another order may put on either side) votes either way: a class
        is kept if its most votes reach every other class's fewest (ties
        to the first class, as libsvm breaks them)."""
        dec = self.decisions([x])[0]
        n_cls = len(self.classes)
        fewest = np.zeros(n_cls, dtype=np.int64)
        most = np.zeros(n_cls, dtype=np.int64)
        p = 0
        for i in range(n_cls):
            for j in range(i + 1, n_cls):
                if abs(dec[p]) <= tol:
                    most[i] += 1
                    most[j] += 1
                else:
                    won = i if dec[p] > 0 else j
                    fewest[won] += 1
                    most[won] += 1
                p += 1
        return [self.classes[c] for c in range(n_cls)
                if all(most[c] > fewest[d] or (most[c] == fewest[d] and c < d)
                       for d in range(n_cls) if d != c)]

