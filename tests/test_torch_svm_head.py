"""The batched SVM head equals sklearn on rows whose decision is near zero.

sklearn ``SVC`` heads (rbf and linear) are fitted on hundredth-rounded
float32 score rows at two shapes: 6 labels and the 40-class chip shape,
both over 40 scores.  Seeded rows drawn in chunks of 10,000 are kept
where sklearn's smallest |decision| is below 2e-5: there a reordered sum
could flip a vote.  On those rows the port's head, built through
``SVMHead.from_sklearn`` and through ``convert.svm_head_from_arrays``,
gives decisions within 1e-12 of sklearn's ``decision_function`` (ovo
shape, same sign) and sklearn's ``predict``; so does the sharded step's
``score``, which keeps the float64 head where the JAX step uses float32.
"""

import functools

import numpy as np
import pytest
import torch
from sklearn.svm import SVC
from torch.utils._python_dispatch import TorchDispatchMode

from xspect2_tpu_torch import convert
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.models.svm_head import SVMHead
from xspect2_tpu_torch.parallel import ShardedClassifier
from xspect2_tpu_torch.parallel.mesh import CLS_AXIS, DATA_AXIS, Mesh

F32 = np.float32
FEATURES = 40
NEAR = 2e-5
# (labels, training rows a label, rows drawn)
SHAPES = {6: (8, 100_000), 40: (2, 20_000)}


def _score_rows(rng, n):
    """Hundredth-rounded float32 scores, as the step makes them."""
    return rng.integers(0, 101, size=(n, FEATURES)).astype(F32) * F32(0.01)


@functools.lru_cache(maxsize=None)
def _fitted(n_labels, kernel):
    """(svc, near-zero rows as float32) for one shape and kernel."""
    per, n_rows = SHAPES[n_labels]
    rng = np.random.default_rng(1000 * n_labels + len(kernel))
    x = _score_rows(rng, n_labels * per).astype(np.float64)
    y = [f"s{v:02d}" for v in np.repeat(np.arange(n_labels), per)]
    svc = SVC(kernel=kernel, C=1.0, decision_function_shape="ovo").fit(x, y)
    near = []
    for _ in range(0, n_rows, 10_000):
        rows = _score_rows(rng, 10_000)
        near.append(rows[np.abs(svc.decision_function(rows.astype(np.float64))).min(axis=1) < NEAR])
    return svc, np.concatenate(near)


def _heads(svc):
    arrays = SVMHead(
        svc.support_vectors_, svc._dual_coef_, svc._intercept_, svc.n_support_, svc.classes_,
        svc.kernel, float(svc._gamma), int(svc.degree), float(svc.coef0),
    )
    via_convert = convert.svm_head_from_arrays(
        svc.support_vectors_, svc._dual_coef_, svc._intercept_, svc.n_support_, list(svc.classes_),
        svc.kernel, float(svc._gamma), int(svc.degree), float(svc.coef0),
    )
    assert torch.equal(arrays.coef, via_convert.coef)
    return {"from_sklearn": SVMHead.from_sklearn(svc), "svm_head_from_arrays": via_convert}


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
@pytest.mark.parametrize("n_labels", sorted(SHAPES))
def test_batched_head_equals_sklearn_on_near_zero_rows(n_labels, kernel):
    svc, near = _fitted(n_labels, kernel)
    assert len(near) >= 20, "too few near-zero rows to test"
    x64 = near.astype(np.float64)
    want_dec = svc.decision_function(x64)
    want = svc.predict(x64)
    for name, head in _heads(svc).items():
        got_dec = head.decision_values(torch.from_numpy(near))
        assert got_dec.dtype == torch.float64 and got_dec.shape == want_dec.shape
        got_dec = got_dec.numpy()
        assert np.abs(got_dec - want_dec).max() < 1e-12, name
        np.testing.assert_array_equal(got_dec > 0, want_dec > 0)
        idx = head.predict_indices(torch.from_numpy(near))
        assert idx.dtype == torch.int64
        np.testing.assert_array_equal(np.asarray(head.classes)[idx.numpy()], want)
        assert head.predict(near) == list(want)


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
@pytest.mark.parametrize("n_labels", sorted(SHAPES))
def test_sharded_score_keeps_the_float64_head(n_labels, kernel):
    """The sharded step's prediction on a near-zero row is sklearn's (C1:
    the JAX step's float32 head is not the target)."""
    svc, near = _fitted(n_labels, kernel)
    names = [f"c{i:02d}" for i in range(FEATURES)]
    index = BlockedBitSlicedIndex.create(21, names, 100)
    mesh = Mesh({DATA_AXIS: 1, CLS_AXIS: 1}, (0, 0), {DATA_AXIS: None, CLS_AXIS: None}, torch.device("cpu"))
    clf = ShardedClassifier(index, mesh, svm_head=SVMHead.from_sklearn(svc))
    want = svc.predict(near.astype(np.float64))
    hits = np.zeros(32 * clf.cw_pad, dtype=np.int32)
    kmers = torch.tensor(100, dtype=torch.int32)
    for row, label in zip(near, want):
        hits[:FEATURES] = np.rint(row * 100)
        scores, pred = clf.score(torch.from_numpy(hits), kmers)
        np.testing.assert_array_equal(scores[:FEATURES].numpy(), row)  # the row the step scores
        assert clf.svm_head.classes[int(pred)] == label


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_a_call_makes_the_same_few_ops_for_any_pair_count(kernel):
    counts = {}
    for n_labels in sorted(SHAPES):
        head = SVMHead.from_sklearn(_fitted(n_labels, kernel)[0])
        x = torch.from_numpy(_fitted(n_labels, kernel)[1][:64])
        with _CountOps() as mode:
            head.predict_indices(x)
        counts[n_labels] = mode.ops
    assert counts[6] == counts[40] < 25, counts
