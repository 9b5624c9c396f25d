"""The one-vs-one SVC species head in one launch: kernel K11.

:func:`svm_head` (``csrc/svm_head.cu``) evaluates a fitted one-vs-one
SVC on score rows: the kernel row against the support vectors, every
class pair's decision in libsvm's order, the votes and the first class
with the most votes, one block a row.  It is the counterpart of the JAX
package's ``JaxSVMHead`` (``xspect2_tpu/models/svm_head.py``), which XLA
ran as plain dots.  The head's parameters are read from any object with
:class:`~xspect2_tpu_torch.models.svm_head.SVMHead`'s buffers and fields.

:func:`svm_head_plain` is the plain PyTorch version: the kernel matrix
(:func:`kernel_row_plain`), ``km @ coef + intercept`` over the head's
[n_sv, n_pairs] ``coef`` and the vote products.  The wrapper uses it
only for rows on the CPU, and counts its kernel launches in
``svm_head.launches``.
"""

import ctypes

import torch

from xspect2_tpu_torch.ops import _kernels

KERNEL_CODES = {"linear": 0, "rbf": 1, "poly": 2, "sigmoid": 3}  # csrc/svm_head.cu:Kernel

_optin: dict = {}  # CUDA device index -> opt-in shared memory a block, bytes


def shared_bytes(n_sv: int, n_features: int, n_classes: int) -> int:
    """Dynamic shared memory of a K11 block: the kernel row and the
    scores in float64, one int32 vote counter a class."""
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


def opt_in_bytes(device: torch.device) -> int:
    """The opt-in shared memory a block of CUDA ``device``, read once."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _optin:
        out = ctypes.c_int()
        with torch.cuda.device(index):
            rc = _kernels.entry("svm_head_optin")(ctypes.addressof(out))
        _kernels.check("svm_head", rc)
        _optin[index] = out.value
    return _optin[index]


def _check(head, x):
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError("x must be a float32 or float64 tensor [n, n_features]")
    sv = head.support_vectors
    if x.shape[1] != sv.shape[1]:
        raise ValueError(f"x has {x.shape[1]} features, the support vectors {sv.shape[1]}")


def svm_head(head, x: torch.Tensor, *, predict: bool = True, decisions: bool = False):
    """``(indices, decisions)`` of the one-vs-one head ``head`` on the
    rows ``x`` (float32 or float64 [n, n_features], computed in float64):
    int64 [n], the first class (index into ``head.classes``) with the
    most votes, when ``predict``; float64 [n, n_pairs], each pair's
    decision in libsvm's pair order, when ``decisions``; else None.

    On a CUDA tensor one K11 launch computes both; it raises
    ``ValueError`` when the head's kernel row does not fit the card's
    opt-in shared memory (:func:`check_shared`).
    """
    _check(head, x)
    if x.device.type == "cpu":
        return svm_head_plain(head, x, predict=predict, decisions=decisions)
    params = (head.support_vectors, head.sv_sq, head.dual_coef, head.intercept, head.starts)
    if any(t.device != x.device or not t.is_contiguous() for t in params):
        raise ValueError("the head's buffers must be contiguous and on the rows' device")
    if x.stride(1) != 1:
        x = x.contiguous()
    n, n_features = x.shape
    n_sv, n_classes = head.support_vectors.shape[0], head.starts.numel() - 1
    smem = check_shared(n_sv, n_features, n_classes, opt_in_bytes(x.device))
    pred = torch.empty(n, dtype=torch.int64, device=x.device) if predict else None
    dec = (torch.empty((n, head.intercept.numel()), dtype=torch.float64, device=x.device)
           if decisions else None)
    if n == 0:
        return pred, dec
    fn = _kernels.entry("svm_head")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(
        x.data_ptr(), x.stride(0), int(x.dtype == torch.float64), head.support_vectors.data_ptr(),
        head.sv_sq.data_ptr(), head.dual_coef.data_ptr(), head.intercept.data_ptr(),
        head.starts.data_ptr(), n, n_features, n_sv, n_classes, KERNEL_CODES[head.kernel],
        head.gamma, head.degree, head.coef0, smem, None if pred is None else pred.data_ptr(),
        None if dec is None else dec.data_ptr(), stream,
    )
    _kernels.check("svm_head", rc)
    svm_head.launches += 1
    return pred, dec


svm_head.launches = 0


def empty_launch(device=None) -> None:
    """Launch an empty kernel on K11's block of one row (256 threads) on
    the current stream: the floor a single call can reach.  For
    measurement only; not counted."""
    device = torch.device("cuda") if device is None else torch.device(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _kernels.check("svm_head", _kernels.entry("svm_head_empty")(stream))
