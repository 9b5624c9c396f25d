"""The one-vs-one SVC species head in one launch: kernel K11.

:func:`svm_head` (``csrc/svm_head.cu``) evaluates a fitted one-vs-one
SVC on score rows: the kernel row against the support vectors, every
class pair's decision in libsvm's order, the votes and the first class
with the most votes, one block a row.  It is the counterpart of the JAX
package's ``JaxSVMHead`` (``xspect2_tpu/models/svm_head.py``), which XLA
ran as plain dots.  The head's parameters are read from any object with
:class:`~xspect2_tpu_torch.models.svm_head.SVMHead`'s buffers and fields.

At the first call on a card the wrapper makes the head's
:class:`LaunchPlan` and keeps it on the head (``head.k11_plan``): the
head's arrays packed once into one device buffer (:func:`head_layout`,
:func:`pack_head`: the support vectors, their squared norms, the
pair-major coefficients, the intercepts and the pair table, each 16 B
aligned), the kernel's parameters and the form, picked by bytes
(:func:`pick_form`): "staged" copies the packed head into shared memory
by TMA, "global" reads it from device memory where it does not fit.  A
call then checks its rows, allocates its outputs and makes one foreign
call with a pointer to the plan.  ``SVMHead`` drops its plan when its
buffers move or are loaded.

:func:`svm_head_plain` is the plain PyTorch version: the kernel matrix
(:func:`kernel_row_plain`), ``km @ coef + intercept`` over the head's
[n_sv, n_pairs] ``coef`` and the vote products.  The wrapper uses it
only for rows on the CPU, and counts its kernel launches in
``svm_head.launches``.
"""

import ctypes

import numpy as np
import torch

from xspect2_tpu_torch.ops import _kernels

KERNEL_CODES = {"linear": 0, "rbf": 1, "poly": 2, "sigmoid": 3}  # csrc/svm_head.cu:Kernel
FORMS = {"staged": 0, "global": 1}  # csrc/svm_head.cu:Form
BAR_BYTES = 16  # csrc/svm_head.cu:kBarBytes, the staged form's mbarrier
ALIGN = 16  # a TMA bulk copy's granule: every array's offset and size
# the packed head's arrays, in order (csrc/svm_head.cu:Plan)
ARRAYS = ("sv", "sv_sq", "coef", "icpt", "pairs")

_optin: dict = {}  # CUDA device index -> opt-in shared memory a block, bytes


def shared_bytes(n_sv: int, n_features: int, n_classes: int) -> int:
    """Dynamic shared memory of a K11 block in the global form: the
    kernel row and the scores in float64, one int32 vote counter a
    class.  The staged form adds the packed head and its mbarrier."""
    return 8 * (n_sv + n_features) + 4 * n_classes


def check_shared(n_sv: int, n_features: int, n_classes: int, optin: int) -> int:
    """:func:`shared_bytes`, or ``ValueError`` when it exceeds ``optin``,
    the card's opt-in shared memory a block."""
    need = shared_bytes(n_sv, n_features, n_classes)
    if need > optin:
        most = (optin - 8 * n_features - 4 * n_classes) // 8
        raise ValueError(
            f"the SVM head needs {need} B of shared memory a block for {n_sv} support vectors, "
            f"above the card's limit of {optin} B ({most} support vectors at {n_features} "
            f"features and {n_classes} classes)"
        )
    return need


def kernel_row_plain(head, x: torch.Tensor) -> torch.Tensor:
    """The kernel matrix [n, n_sv] of float64 rows ``x`` against the
    head's support vectors (rbf reads their squared norms ``sv_sq``)."""
    sv = head.support_vectors
    if head.kernel == "linear":
        return x @ sv.T
    if head.kernel == "rbf":
        d2 = (x**2).sum(dim=1)[:, None] + head.sv_sq[None, :] - 2.0 * (x @ sv.T)
        return torch.exp(-head.gamma * d2)
    if head.kernel == "poly":
        return (head.gamma * (x @ sv.T) + head.coef0) ** head.degree
    return torch.tanh(head.gamma * (x @ sv.T) + head.coef0)


def svm_head_plain(head, x: torch.Tensor, *, predict: bool = True, decisions: bool = False):
    """Plain PyTorch version of :func:`svm_head`."""
    x = x.to(torch.float64)
    dec = kernel_row_plain(head, x) @ head.coef + head.intercept
    pred = None
    if predict:
        pos = (dec > 0).to(torch.float64)
        votes = pos @ head.w_pos + (1 - pos) @ head.w_neg
        # torch.argmax returns the first maximal index, libsvm's tie rule
        pred = torch.argmax(votes, dim=1)
    return pred, dec if decisions else None


def head_layout(n_sv: int, n_features: int, n_classes: int, kernel: str) -> tuple[dict, int]:
    """``({array: (byte offset, padded bytes)}, total bytes)`` of the
    packed head, the arrays in :data:`ARRAYS` order, each padded to a
    multiple of :data:`ALIGN` so that every offset is one: the support
    vectors (float64 [n_sv, n_features], rows :func:`sv_stride` apart,
    zeros between them), their squared norms (float64 [n_sv], rbf
    only), the pair-major coefficients (float64 [(n_classes - 1) *
    n_sv]), the intercepts (float64 [n_pairs]) and the pair table
    (uint32 [n_pairs, 4])."""
    n_pairs = n_classes * (n_classes - 1) // 2
    sizes = {"sv": 8 * n_sv * sv_stride(n_features), "sv_sq": 8 * n_sv if kernel == "rbf" else 0,
             "coef": 8 * (n_classes - 1) * n_sv, "icpt": 8 * n_pairs, "pairs": 16 * n_pairs}
    layout, at = {}, 0
    for name in ARRAYS:
        padded = -(-sizes[name] // ALIGN) * ALIGN
        layout[name] = (at, padded)
        at += padded
    return layout, at


def sv_stride(n_features: int) -> int:
    """The packed support vectors' row stride in doubles: odd, so that
    lanes reading the same feature of different rows hit different
    shared-memory banks (csrc/svm_head.cu, phase 1)."""
    return n_features | 1


def _pair_arrays(n_support):
    n = np.asarray(n_support, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(n)])
    i, j = np.triu_indices(len(n), 1)  # libsvm's pair order: i < j, row-major
    width = n[i] + n[j]
    return n, starts, i, j, width, np.cumsum(width) - width


def pair_table(n_support) -> np.ndarray:
    """uint32 [n_pairs, 4]: for each pair (i, j) in libsvm's order, the
    first of its coefficients in :func:`pair_coefficients`, ``start_i |
    n_i << 16``, ``start_j | n_j << 16`` (each class's first support
    vector and count) and ``i | j << 16``."""
    n, starts, i, j, _, first = _pair_arrays(n_support)
    if starts[-1] > 0xFFFF or len(n) > 0x10000:
        raise ValueError(f"the pair table holds at most 65,535 support vectors and 65,536 classes, "
                         f"not {starts[-1]} and {len(n)}")
    return np.stack([first, starts[i] | n[i] << 16, starts[j] | n[j] << 16, i | j << 16], axis=1).astype(np.uint32)


def pair_coefficients(dual_coef: np.ndarray, n_support) -> np.ndarray:
    """float64 [(n_classes - 1) * n_sv]: pair after pair in libsvm's
    order, class i's segment of ``dual_coef[j - 1]`` then class j's
    segment of ``dual_coef[i]``, the coefficients pair (i, j) sums."""
    n, starts, i, j, width, first = _pair_arrays(n_support)
    pair = np.repeat(np.arange(len(i)), width)
    pos = np.arange(int(width.sum())) - first[pair]
    in_i = pos < n[i][pair]
    col = np.where(in_i, starts[i][pair] + pos, starts[j][pair] + pos - n[i][pair])
    row = np.where(in_i, j[pair] - 1, i[pair])
    return np.asarray(dual_coef, dtype=np.float64)[row, col]


def pack_head(head) -> tuple[np.ndarray, dict, int]:
    """``(uint8 buffer, layout, total bytes)``: the head's arrays packed
    at :func:`head_layout`'s offsets, zeros in the padding."""
    sv = head.support_vectors.detach().cpu().numpy()
    n_support = np.diff(head.starts.cpu().numpy().astype(np.int64))
    n_sv, n_features = sv.shape
    layout, total = head_layout(n_sv, n_features, len(n_support), head.kernel)
    padded = np.zeros((n_sv, sv_stride(n_features)))
    padded[:, :n_features] = sv
    arrays = {"sv": padded, "sv_sq": head.sv_sq.detach().cpu().numpy() if head.kernel == "rbf" else None,
              "coef": pair_coefficients(head.dual_coef.detach().cpu().numpy(), n_support),
              "icpt": head.intercept.detach().cpu().numpy(), "pairs": pair_table(n_support)}
    blob = np.zeros(total, dtype=np.uint8)
    for name, value in arrays.items():
        if value is not None and value.size:
            raw = np.ascontiguousarray(value).view(np.uint8).reshape(-1)
            blob[layout[name][0]:layout[name][0] + raw.size] = raw
    return blob, layout, total


def pick_form(head_bytes: int, n_sv: int, n_features: int, n_classes: int, optin: int) -> tuple[str, int, int]:
    """``(form, staged shared bytes or 0, global shared bytes)``: "staged"
    where the packed head, its mbarrier and the global form's shared
    memory fit ``optin``, else "global"; ``ValueError`` where even the
    kernel row does not (:func:`check_shared`)."""
    global_smem = check_shared(n_sv, n_features, n_classes, optin)
    staged_smem = BAR_BYTES + head_bytes + global_smem
    if staged_smem <= optin:
        return "staged", staged_smem, global_smem
    return "global", 0, global_smem


class _Plan(ctypes.Structure):
    """``csrc/svm_head.cu:Plan``, field for field."""

    _fields_ = [
        ("head", ctypes.c_void_p),
        *((name, ctypes.c_uint32) for name in ARRAYS),
        ("head_bytes", ctypes.c_uint32),
        ("n_features", ctypes.c_int32), ("n_sv", ctypes.c_int32), ("n_classes", ctypes.c_int32),
        ("n_pairs", ctypes.c_int32), ("kernel", ctypes.c_int32), ("degree", ctypes.c_int32),
        ("gamma", ctypes.c_double), ("coef0", ctypes.c_double),
        ("staged_smem", ctypes.c_int32), ("global_smem", ctypes.c_int32),
    ]


class LaunchPlan:
    """K11's launch of one head on one device, made once: the packed head
    (``buffer``, on ``device``), the kernel's parameters and the form
    (``form``; :func:`pick_form` with ``optin``, the card's opt-in shared
    memory a block), as the C struct ``struct`` that a call passes by
    pointer (``ref``).  ``ValueError`` when the head's buffers are not
    contiguous on ``device``, or its kernel row does not fit ``optin``."""

    def __init__(self, head, device: torch.device, optin: int):
        params = (head.support_vectors, head.sv_sq, head.dual_coef, head.intercept, head.starts)
        if any(t.device != device or not t.is_contiguous() for t in params):
            raise ValueError("the head's buffers must be contiguous and on the rows' device")
        n_sv, n_features = head.support_vectors.shape
        n_classes = head.starts.numel() - 1
        layout, head_bytes = head_layout(n_sv, n_features, n_classes, head.kernel)
        if head_bytes >= 2**32:
            raise ValueError(f"the packed SVM head takes {head_bytes} B, above 4 GiB")
        self.form, staged_smem, global_smem = pick_form(head_bytes, n_sv, n_features, n_classes, optin)
        blob, _, _ = pack_head(head)
        self.buffer = torch.from_numpy(blob).to(device)
        self.device, self.n_features = device, n_features
        self.n_pairs = n_classes * (n_classes - 1) // 2
        self.struct = _Plan(
            self.buffer.data_ptr(), *(layout[name][0] for name in ARRAYS), head_bytes, n_features, n_sv,
            n_classes, self.n_pairs, KERNEL_CODES[head.kernel], head.degree, head.gamma, head.coef0,
            staged_smem, global_smem,
        )
        self.ref = ctypes.addressof(self.struct)


def opt_in_bytes(device: torch.device) -> int:
    """The opt-in shared memory a block of CUDA ``device``, read once;
    K11's kernels are allowed that much dynamic shared memory there."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _optin:
        out = ctypes.c_int()
        with torch.cuda.device(index):
            rc = _kernels.entry("svm_head_optin")(ctypes.addressof(out))
        _kernels.check("svm_head", rc)
        _optin[index] = out.value
    return _optin[index]


def plan_for(head, device: torch.device) -> LaunchPlan:
    """The head's launch plan on CUDA ``device``, made at the first call
    there and kept on the head (``head.k11_plan``)."""
    plan = getattr(head, "k11_plan", None)
    if plan is None or plan.device != device:
        plan = LaunchPlan(head, device, opt_in_bytes(device))
        head.k11_plan = plan
    return plan


def _check_features(x, n_features: int):
    if x.shape[1] != n_features:
        raise ValueError(f"x has {x.shape[1]} features, the support vectors {n_features}")


def svm_head(head, x: torch.Tensor, *, predict: bool = True, decisions: bool = False, form: str | None = None):
    """``(indices, decisions)`` of the one-vs-one head ``head`` on the
    rows ``x`` (float32 or float64 [n, n_features], computed in float64):
    int64 [n], the first class (index into ``head.classes``) with the
    most votes, when ``predict``; float64 [n, n_pairs], each pair's
    decision in libsvm's pair order, when ``decisions``; else None.

    On a CUDA tensor one K11 launch computes both, in the form of the
    head's plan, or in ``form`` ("staged" or "global") where given; it
    raises ``ValueError`` when the head's kernel row does not fit the
    card's opt-in shared memory (:func:`check_shared`), or when the
    staged form is asked for and the packed head does not fit.
    """
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError("x must be a float32 or float64 tensor [n, n_features]")
    if x.device.type == "cpu":
        _check_features(x, head.support_vectors.shape[1])
        return svm_head_plain(head, x, predict=predict, decisions=decisions)
    plan = plan_for(head, x.device)
    _check_features(x, plan.n_features)
    code = FORMS[plan.form if form is None else form]
    if code == FORMS["staged"] and not plan.struct.staged_smem:
        raise ValueError("the packed SVM head does not fit the card's shared memory: no staged form")
    if x.stride(1) != 1:
        x = x.contiguous()
    n = x.shape[0]
    pred = torch.empty(n, dtype=torch.int64, device=x.device) if predict else None
    dec = torch.empty((n, plan.n_pairs), dtype=torch.float64, device=x.device) if decisions else None
    if n == 0:
        return pred, dec
    rc = _kernels.entry("svm_head")(
        plan.ref, code, x.data_ptr(), x.stride(0), x.dtype == torch.float64, n,
        None if pred is None else pred.data_ptr(), None if dec is None else dec.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _kernels.check("svm_head", rc)
    svm_head.launches += 1
    return pred, dec


svm_head.launches = 0


def empty_launch(device=None) -> None:
    """Launch an empty kernel on K11's block of one row (512 threads) on
    the current stream: the floor a single call can reach.  For
    measurement only; not counted."""
    device = torch.device("cuda") if device is None else torch.device(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _kernels.check("svm_head", _kernels.entry("svm_head_empty")(stream))
