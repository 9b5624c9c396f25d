"""K11's function, the one-vs-one SVC head, held against the JAX package.

sklearn ``SVC`` heads of all four kernel types are fitted on seeded
score rows (each class high in its own column) at 2, 6 and 40 classes
over 40 scores.  On seeded rows drawn from the same distribution, half
of them between two classes, the port's head (the plain version here:
the rows lie on the CPU) gives

- the JAX head's class indices (``JaxSVMHead.predict_indices(x,
  xp=np)``, float32: C1) on every row whose class no float32 decision
  within 1e-3 of zero could change, among them every row whose float32
  decisions all lie at least 1e-3 from zero;
- sklearn's float64 ``decision_function`` (ovo) within 1e-12 and its
  ``predict`` on every row, as the JAX main path predicts;
- the same bits as the formula that recomputed the support vectors'
  squared norms on every call, now read from ``sv_sq``.

A numpy emulation of ``csrc/svm_head.cu`` on the head packed as its
launch plan packs it (phase 1's groups of lanes over features and xor
butterfly, each pair read from the pair table and summed segment i,
segment j, intercept from its run of coefficients, the votes and warp
0's first maximum) is within 1e-12 of the plain version; the pair table
holds every pair once, in libsvm's order, at 2-512 classes; the packed
head's arrays lie at 16 B multiples, and the form follows the bytes at
the edge of the opt-in size; the wrapper's shared-memory check raises
``ValueError`` past the card's limit, as a pure function; the plan
mirrors the kernel's struct and is dropped when the head moves.
"""

import ctypes
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from sklearn.svm import SVC

from xspect2_tpu.models.svm_head import JaxSVMHead
from xspect2_tpu_torch.models.svm_head import SVMHead
from xspect2_tpu_torch.ops import svm_head as ops

SOURCE = Path(__file__).resolve().parent.parent / "xspect2_tpu_torch" / "csrc" / "svm_head.cu"
KERNELS = ["linear", "rbf", "poly", "sigmoid"]
CLASSES = [2, 6, 40]
FEATURES = 40
ROWS = 300
H100_OPTIN = 232_448  # opt-in shared memory a block of an H100 (227 KB)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every tensor here is small: one intra-op thread keeps the plain
    version's ops from waiting on other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _threads() -> int:
    return int(re.search(r"constexpr int kThreads = (\d+);", SOURCE.read_text(encoding="utf-8")).group(1))


def _score_rows(rng, labels, second=None):
    """Score rows around 0.05 with each row's own class at 0.4-0.6 (and a
    second class as high, where given)."""
    x = np.clip(rng.normal(0.05, 0.02, (len(labels), FEATURES)), 0, 1)
    x[np.arange(len(labels)), labels] = rng.uniform(0.4, 0.6, len(labels))
    if second is not None:
        x[np.arange(len(labels)), second] = rng.uniform(0.4, 0.6, len(labels))
    return x


@functools.lru_cache(maxsize=None)
def _fitted(n_classes, kernel):
    """(svc, float32 rows): the fit on hundredth-rounded rows, a few a
    class; half the rows one class high, half two classes high."""
    rng = np.random.default_rng(100 * n_classes + KERNELS.index(kernel))
    per = 2 if n_classes > 6 else 6
    y = np.repeat(np.arange(n_classes), per)
    x = np.round(_score_rows(rng, y), 2)
    svc = SVC(kernel=kernel, C=1.0, decision_function_shape="ovo").fit(x, [f"s{v:02d}" for v in y])
    half = ROWS // 2
    rows = np.concatenate([
        _score_rows(rng, rng.integers(0, n_classes, half)),
        _score_rows(rng, rng.integers(0, n_classes, half), rng.integers(0, n_classes, half)),
    ]).astype(np.float32)
    return svc, rows


def _ovo_decisions(svc, x):
    """sklearn's decisions in libsvm's sign (sklearn flips a binary one)."""
    dec = svc.decision_function(x)
    return -dec[:, None] if dec.ndim == 1 else dec


def _settled(dec, n_classes, tie):
    """Rows whose first class with the most votes no decision within
    ``tie`` of zero could change, whatever its sign: the class's votes
    with every such decision against it beat (or, for a later class,
    equal) every other class's votes with every such decision for it."""
    pairs = [(i, j) for i in range(n_classes) for j in range(i + 1, n_classes)]
    w_pos, w_neg = np.zeros((len(pairs), n_classes)), np.zeros((len(pairs), n_classes))
    for p, (i, j) in enumerate(pairs):
        w_pos[p, i] = w_neg[p, j] = 1
    pos, neg = dec > tie, dec < -tie
    low = pos @ w_pos + neg @ w_neg
    high = low + (~pos & ~neg) @ (w_pos + w_neg)
    top = np.argmax((dec > 0) @ w_pos + (dec <= 0) @ w_neg, axis=1)
    low_top = low[np.arange(len(dec)), top][:, None]
    later = np.arange(n_classes)[None, :] > top[:, None]
    beats = (low_top > high) | ((low_top == high) & later)
    beats[np.arange(len(dec)), top] = True
    return beats.all(axis=1)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("n_classes", CLASSES)
def test_head_gives_the_jax_heads_classes_on_settled_rows(n_classes, kernel):
    """Every row whose float32 decisions all lie at least 1e-3 from zero,
    and every row whose class no decision within 1e-3 of zero could
    change (at 40 classes most rows have a pair of two other classes
    near zero)."""
    svc, rows = _fitted(n_classes, kernel)
    jax_head = JaxSVMHead.from_sklearn(svc)
    dec32 = np.asarray(jax_head.decision_values(rows, xp=np))
    assert dec32.dtype == np.float32
    settled = _settled(dec32, n_classes, 1e-3)
    assert (settled | (np.abs(dec32).min(axis=1) < 1e-3)).all()
    assert settled.sum() >= ROWS // 4, "too few settled rows"
    want = np.asarray(jax_head.predict_indices(rows, xp=np))
    got = SVMHead.from_sklearn(svc).predict_indices(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got[settled], want[settled])


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("n_classes", CLASSES)
def test_head_equals_sklearn_in_float64(n_classes, kernel):
    """The JAX main path predicts with sklearn's float64 SVC."""
    svc, rows = _fitted(n_classes, kernel)
    x64 = rows.astype(np.float64)
    head = SVMHead.from_sklearn(svc)
    got = head.decision_values(torch.from_numpy(rows))
    assert got.dtype == torch.float64 and got.shape == (ROWS, n_classes * (n_classes - 1) // 2)
    assert np.abs(got.numpy() - _ovo_decisions(svc, x64)).max() < 1e-12
    assert head.predict(rows) == list(svc.predict(x64))
    # a list of Python floats is taken in float64, as the species model passes it
    assert head.predict(x64[:3].tolist()) == list(svc.predict(x64[:3]))


def _decisions_with_norms_per_call(head, x):
    """The plain decisions as computed before ``sv_sq``: the squared
    norms summed again on every call."""
    x = torch.as_tensor(x, dtype=torch.float64)
    sv = head.support_vectors
    dot = x @ sv.T
    if head.kernel == "linear":
        km = dot
    elif head.kernel == "rbf":
        km = torch.exp(-head.gamma * ((x**2).sum(dim=1)[:, None] + (sv**2).sum(dim=1)[None, :] - 2.0 * dot))
    elif head.kernel == "poly":
        km = (head.gamma * dot + head.coef0) ** head.degree
    else:
        km = torch.tanh(head.gamma * dot + head.coef0)
    return km @ head.coef + head.intercept


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("n_classes", CLASSES)
def test_sv_sq_keeps_the_plain_versions_bits(n_classes, kernel):
    svc, rows = _fitted(n_classes, kernel)
    head = SVMHead.from_sklearn(svc)
    assert torch.equal(head.sv_sq, (head.support_vectors**2).sum(dim=1))
    assert head.starts.dtype == torch.int32
    assert head.starts.tolist() == [0, *np.cumsum(svc.n_support_).tolist()]
    want = _decisions_with_norms_per_call(head, torch.from_numpy(rows))
    assert torch.equal(head.decision_values(torch.from_numpy(rows)), want)
    pos = (want > 0).double()
    votes = pos @ head.w_pos + (1 - pos) @ head.w_neg
    assert torch.equal(head.predict_indices(torch.from_numpy(rows)), torch.argmax(votes, dim=1))


def _powi(base, times):
    tmp, ret = base, np.ones_like(base)
    while times > 0:
        if times % 2 == 1:
            ret = ret * tmp
        tmp = tmp * tmp
        times //= 2
    return ret


def _unpack(head):
    """The packed head (``ops.pack_head``) read back at its offsets:
    (sv, sv_sq or None, pair-major coefficients, intercepts, pair table)."""
    blob, layout, total = ops.pack_head(head)
    assert blob.dtype == np.uint8 and blob.size == total
    n_sv, n_features = head.support_vectors.shape
    n_pairs = len(head.pairs)

    def at(name, dtype, count):
        off, size = layout[name]
        assert count * np.dtype(dtype).itemsize <= size
        return blob[off:off + count * np.dtype(dtype).itemsize].view(dtype)

    sv_sq = at("sv_sq", np.float64, n_sv) if head.kernel == "rbf" else None
    stride = ops.sv_stride(n_features)
    assert stride % 2 == 1 and stride - n_features in (0, 1)
    rows = at("sv", np.float64, n_sv * stride).reshape(n_sv, stride)
    assert not rows[:, n_features:].any()
    return (rows[:, :n_features], sv_sq,
            at("coef", np.float64, (len(head.classes) - 1) * n_sv), at("icpt", np.float64, n_pairs),
            at("pairs", np.uint32, 4 * n_pairs).reshape(n_pairs, 4))


def _lane_sums(terms, lanes):
    """K11's phase-1 order over the last axis: lane l of a group of
    ``lanes`` sums terms l, l + lanes, ... in order, then the xor
    butterfly of lanes / 2, ..., 2, 1 lanes."""
    part = np.zeros(terms.shape[:-1] + (lanes,))
    for f in range(terms.shape[-1]):
        part[..., f % lanes] = part[..., f % lanes] + terms[..., f]
    d = lanes // 2
    while d >= 1:
        part = part + part[..., np.arange(lanes) ^ d]
        d //= 2
    assert (part == part[..., :1]).all()  # every lane holds the sum
    return part[..., 0]


def _sv_lanes(n_sv, threads):
    """Lanes a support vector: the largest power of two up to 32 with
    n_sv * lanes <= threads / 2."""
    q = 32
    while q > 1 and n_sv * q > threads // 2:
        q //= 2
    return q


def _emulate_k11(head, x):
    """K11's arithmetic and order in numpy, for all rows at once, on the
    head packed as its launch plan packs it: ``(indices, decisions,
    the pair (i, j) the table gave each column)``."""
    threads = _threads()
    x = x.astype(np.float64)
    sv, sv_sq, coef, intercept, table = _unpack(head)
    n, n_classes = len(x), len(head.classes)
    dot = _lane_sums(x[:, None, :] * sv[None, :, :], _sv_lanes(len(sv), threads))
    if head.kernel == "linear":
        km = dot
    elif head.kernel == "rbf":
        xx = _lane_sums(x * x, 32)
        km = np.exp(-head.gamma * (xx[:, None] + sv_sq[None, :] - 2.0 * dot))
    elif head.kernel == "poly":
        km = _powi(head.gamma * dot + head.coef0, head.degree)
    else:
        km = np.tanh(head.gamma * dot + head.coef0)
    n_pairs = n_classes * (n_classes - 1) // 2
    dec = np.empty((n, n_pairs))
    votes = np.zeros((n, n_classes), dtype=np.int64)
    walked = [None] * n_pairs
    for t in range(threads):
        for p in range(t, n_pairs, threads):
            first, seg_i, seg_j, ij = (int(v) for v in table[p])
            i, j = ij & 0xFFFF, ij >> 16
            walked[p] = (i, j)
            s = np.zeros(n)
            c = first
            for start, count in ((seg_i & 0xFFFF, seg_i >> 16), (seg_j & 0xFFFF, seg_j >> 16)):
                for k in range(count):
                    s = s + coef[c] * km[:, start + k]
                    c += 1
            dec[:, p] = s + intercept[p]
            votes[np.arange(n), np.where(dec[:, p] > 0, i, j)] += 1
    # warp 0: each lane the first maximum of its classes, then the butterfly
    lanes = [(votes[:, c::32].max(axis=1, initial=-1), c + 32 * np.argmax(votes[:, c::32], axis=1))
             if c < n_classes else (np.full(n, -1), np.full(n, n_classes)) for c in range(32)]
    best, cls = np.stack([v for v, _ in lanes]), np.stack([c for _, c in lanes])
    for d in (16, 8, 4, 2, 1):
        other = np.arange(32) ^ d
        v, c = best[other], cls[other]
        take = (v > best) | ((v == best) & (c < cls))
        best, cls = np.where(take, v, best), np.where(take, c, cls)
    return cls[0], dec, walked


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("n_classes", CLASSES)
def test_kernels_order_is_within_rounding_of_the_plain_version(n_classes, kernel):
    svc, rows = _fitted(n_classes, kernel)
    head = SVMHead.from_sklearn(svc)
    pred, dec, walked = _emulate_k11(head, rows)
    assert walked == head.pairs  # every pair once, in libsvm's order
    want_dec = head.decision_values(torch.from_numpy(rows)).numpy()
    assert np.abs(dec - want_dec).max() < 1e-12
    settled = np.abs(want_dec).min(axis=1) > 1e-9
    assert settled.sum() >= ROWS // 2
    want = head.predict_indices(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(pred[settled], want[settled])
    np.testing.assert_array_equal(pred, np.argmax(
        np.stack([(dec > 0) @ head.w_pos.numpy(), (dec <= 0) @ head.w_neg.numpy()]).sum(axis=0), axis=1))


@pytest.mark.parametrize("n_classes", [2, 3, 6, 40, 255, 256, 257, 512])
def test_the_pair_walk_covers_every_pair_once(n_classes):
    """The pair table at the 512-class tables too (130,816 pairs), and at
    class counts around the block's width, with 1-3 support vectors a
    class: every pair once, in libsvm's order, each with its classes'
    segments and the run of coefficients it sums, the runs back to back."""
    rng = np.random.default_rng(n_classes)
    n_support = rng.integers(1, 4, n_classes)
    starts = np.concatenate([[0], np.cumsum(n_support)])
    n_sv = int(starts[-1])
    table = ops.pair_table(n_support)
    pairs = [(i, j) for i in range(n_classes) for j in range(i + 1, n_classes)]
    assert table.dtype == np.uint32 and table.shape == (len(pairs), 4)
    i, j = (table[:, 3] & 0xFFFF).astype(np.int64), (table[:, 3] >> 16).astype(np.int64)
    assert list(zip(i.tolist(), j.tolist())) == pairs
    np.testing.assert_array_equal(table[:, 1] & 0xFFFF, starts[i])
    np.testing.assert_array_equal(table[:, 1] >> 16, n_support[i])
    np.testing.assert_array_equal(table[:, 2] & 0xFFFF, starts[j])
    np.testing.assert_array_equal(table[:, 2] >> 16, n_support[j])
    width = n_support[i] + n_support[j]
    np.testing.assert_array_equal(table[:, 0], np.cumsum(width) - width)
    dual = rng.uniform(-1, 1, (n_classes - 1, n_sv))
    coef = ops.pair_coefficients(dual, n_support)
    assert coef.shape == ((n_classes - 1) * n_sv,) == (int(width.sum()),)
    for p in sorted({0, len(pairs) - 1, *rng.integers(0, len(pairs), 300).tolist()}):
        a, b = pairs[p]
        run = coef[table[p, 0]:table[p, 0] + width[p]]
        want = np.concatenate([dual[b - 1, starts[a]:starts[a + 1]], dual[a, starts[b]:starts[b + 1]]])
        np.testing.assert_array_equal(run, want)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("n_classes", CLASSES + [512])
def test_the_packed_head_is_16_byte_aligned_and_the_form_follows_the_bytes(n_classes, kernel):
    """Every array of the packed head starts at a multiple of 16 B and
    takes one, back to back with zeros in the padding; the staged form is
    picked up to the byte where the packed head, its mbarrier and the
    kernel row fit the opt-in size, the global form below that, and
    ``ValueError`` below the kernel row."""
    n_sv = 2 * n_classes + 1  # odd: the support vectors' arrays need padding
    n_features = FEATURES + 1
    layout, total = ops.head_layout(n_sv, n_features, n_classes, kernel)
    assert list(layout) == list(ops.ARRAYS)
    at = 0
    for name in ops.ARRAYS:
        offset, size = layout[name]
        assert offset == at and offset % 16 == 0 and size % 16 == 0
        at += size
    assert total == at
    n_pairs = n_classes * (n_classes - 1) // 2
    assert ops.sv_stride(n_features) == n_features  # odd already
    assert layout["sv"][1] - 8 * n_sv * n_features in (0, 8)
    assert layout["sv_sq"][1] == (-(-8 * n_sv // 16) * 16 if kernel == "rbf" else 0)
    assert layout["pairs"][1] == 16 * n_pairs
    row = ops.shared_bytes(n_sv, n_features, n_classes)
    edge = ops.BAR_BYTES + total + row
    assert ops.pick_form(total, n_sv, n_features, n_classes, edge) == ("staged", edge, row)
    assert ops.pick_form(total, n_sv, n_features, n_classes, edge - 1) == ("global", 0, row)
    assert ops.pick_form(total, n_sv, n_features, n_classes, row) == ("global", 0, row)
    with pytest.raises(ValueError, match="shared memory"):
        ops.pick_form(total, n_sv, n_features, n_classes, row - 1)
    # on an H100: the smoke's 40-class heads stage, its 512-class head reads device memory
    form = ops.pick_form(total, n_sv, n_features, n_classes, H100_OPTIN)[0]
    assert form == ("global" if n_classes == 512 else "staged")
    svc, _ = _fitted(n_classes, kernel) if n_classes in CLASSES else (None, None)
    if svc is not None:
        head = SVMHead.from_sklearn(svc)
        blob, packed, size = ops.pack_head(head)
        assert (packed, size) == ops.head_layout(*head.support_vectors.shape, n_classes, kernel)
        used = np.zeros(size, dtype=bool)
        stride = ops.sv_stride(head.support_vectors.shape[1])
        for name, count in (("sv", head.support_vectors.shape[0] * stride * 8), ("coef", head.dual_coef.numel() * 8),
                            ("icpt", n_pairs * 8), ("pairs", n_pairs * 16),
                            ("sv_sq", head.sv_sq.numel() * 8 if kernel == "rbf" else 0)):
            used[packed[name][0]:packed[name][0] + count] = True
        assert not blob[~used].any()


@pytest.mark.parametrize("n_classes", CLASSES + [512])
def test_the_shared_memory_check_raises_past_the_cards_limit(n_classes):
    most = (H100_OPTIN - 8 * FEATURES - 4 * n_classes) // 8
    assert 28_000 < most < 29_100
    assert ops.check_shared(most, FEATURES, n_classes, H100_OPTIN) == ops.shared_bytes(most, FEATURES, n_classes)
    assert ops.check_shared(80, FEATURES, n_classes, H100_OPTIN) == 8 * (80 + FEATURES) + 4 * n_classes
    with pytest.raises(ValueError, match=f"limit of {H100_OPTIN} B .{most} support vectors"):
        ops.check_shared(most + 1, FEATURES, n_classes, H100_OPTIN)


def test_the_wrapper_runs_the_plain_version_on_the_cpu_and_checks_its_rows():
    svc, rows = _fitted(6, "rbf")
    head = SVMHead.from_sklearn(svc)
    x = torch.from_numpy(rows)
    before = ops.svm_head.launches
    pred, dec = ops.svm_head(head, x, decisions=True)
    want_pred, want_dec = ops.svm_head_plain(head, x, decisions=True)
    assert ops.svm_head.launches == before
    assert torch.equal(pred, want_pred) and torch.equal(dec, want_dec)
    assert ops.svm_head(head, x, predict=False) == (None, None)
    with pytest.raises(ValueError, match="float32 or float64"):
        ops.svm_head(head, x.int())
    with pytest.raises(ValueError, match="features"):
        ops.svm_head(head, x[:, :-1])


def test_the_launch_plan_mirrors_the_kernels_struct_and_is_dropped_when_the_head_moves():
    """``_Plan`` has ``csrc/svm_head.cu:Plan``'s fields in order and its
    size; a plan (made here on the CPU, as it is made on the card, and
    never launched) holds the packed head and the head's parameters;
    ``.to()``, a dtype cast and ``load_state_dict`` drop it."""
    src = SOURCE.read_text(encoding="utf-8")
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = [name for decl in re.sub(r"//[^\n]*", "", body).split(";")
              for name in re.findall(r"(\w+)\s*(?=,|$)", decl.strip())]
    assert [name for name, _ in ops._Plan._fields_] == fields
    assert ctypes.sizeof(ops._Plan) == int(re.search(r"sizeof\(Plan\) == (\d+)", src).group(1))

    svc, rows = _fitted(6, "rbf")
    head = SVMHead.from_sklearn(svc)
    plan = ops.LaunchPlan(head, torch.device("cpu"), H100_OPTIN)
    blob, layout, total = ops.pack_head(head)
    assert plan.form == "staged" and torch.equal(plan.buffer, torch.from_numpy(blob))
    s = plan.struct
    assert s.head == plan.buffer.data_ptr() and ctypes.addressof(s) == plan.ref
    assert [getattr(s, name) for name in ops.ARRAYS] == [layout[name][0] for name in ops.ARRAYS]
    assert (s.head_bytes, s.n_features, s.n_sv, s.n_classes, s.n_pairs) == (
        total, FEATURES, head.support_vectors.shape[0], 6, 15)
    assert (s.kernel, s.degree, s.gamma, s.coef0) == (ops.KERNEL_CODES["rbf"], head.degree, head.gamma, head.coef0)
    assert s.global_smem == ops.shared_bytes(head.support_vectors.shape[0], FEATURES, 6)
    assert s.staged_smem == ops.BAR_BYTES + total + s.global_smem
    for move in (lambda h: h.to("cpu"), lambda h: h.to(torch.float64), lambda h: h.double(),
                 lambda h: h.load_state_dict(h.state_dict())):
        head.k11_plan = plan
        move(head)
        assert head.k11_plan is None
    assert SVMHead.k11_plan is None
    other = SVMHead.from_sklearn(svc)
    other.k11_plan = plan
    with pytest.raises(ValueError, match="contiguous and on the rows' device"):
        ops.LaunchPlan(head, torch.device("meta"), H100_OPTIN)
    assert head.k11_plan is None and other.k11_plan is plan
    np.testing.assert_array_equal(head.predict_indices(torch.from_numpy(rows)).numpy(),
                                  other.predict_indices(torch.from_numpy(rows)).numpy())
