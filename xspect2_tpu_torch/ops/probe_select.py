"""The AND of the selected rows of gathered table blocks: kernel K8.

:func:`probe_select` (``csrc/probe_select.cu``) is the post-gather pass
of the read query as a kernel of its own, the counterpart of the Pallas
kernel ``sel_kernel`` of the JAX package's ``tools/microbench_pallas.py``:
the caller gathers each k-mer's 512-byte block and packs its probe rows
into a row mask, the kernel ANDs the selected rows of every class
word's segment.  The shipped read query (K2) never gathers the block;
this kernel exists for the microbenchmark
(:mod:`xspect2_tpu_torch.tools.microbench_probe`) that holds the two
formulations side by side.

:func:`probe_select_plain` is the plain PyTorch version of the same
function; the wrapper uses it only for tensors on the CPU, and counts
its kernel launches in ``probe_select.launches``.
"""

import torch

from xspect2_tpu_torch.core.hashing import MASK32
from xspect2_tpu_torch.ops import _kernels

BLOCK_WORDS = 128  # uint32 words of one gathered block (512 bytes)


def _check(selbits, blocks, rows_per_block, class_words):
    rpb = rows_per_block
    if rpb < 8 or rpb & (rpb - 1) or rpb * class_words != BLOCK_WORDS:
        raise ValueError(
            f"rows_per_block must be a power of two >= 8 with rows_per_block * class_words "
            f"== {BLOCK_WORDS}, not {rpb} x {class_words}"
        )
    if blocks.dtype != torch.int32 or blocks.dim() != 2 or blocks.shape[1] != BLOCK_WORDS:
        raise ValueError(f"blocks must be an int32 tensor [T, {BLOCK_WORDS}] (uint32 bits)")
    sel_words = max(1, rpb // 32)
    if selbits.dtype != torch.int32 or tuple(selbits.shape) != (blocks.shape[0], sel_words):
        raise ValueError(
            f"selbits must be an int32 tensor [T, {sel_words}] (uint32 bits), one row mask per k-mer"
        )


def probe_select_plain(
    selbits: torch.Tensor, blocks: torch.Tensor, *, rows_per_block: int, class_words: int
) -> torch.Tensor:
    """Plain PyTorch version of :func:`probe_select`.

    Computes in int64 holding uint32 values (PyTorch has no uint32
    shifts on the CPU).
    """
    _check(selbits, blocks, rows_per_block, class_words)
    rpb = rows_per_block
    t = blocks.shape[0]
    rows = torch.arange(rpb, device=blocks.device)
    sel = ((selbits.long() & MASK32)[:, rows // 32] >> (rows % 32)) & 1  # [T, rpb]
    x = (blocks.long() & MASK32).view(t, class_words, rpb)
    x = torch.where(sel[:, None, :] == 1, x, MASK32)
    while x.shape[2] > 1:  # AND the two halves until one row is left
        half = x.shape[2] // 2
        x = x[:, :, :half] & x[:, :, half:]
    return x[:, :, 0].to(torch.int32)


def probe_select(
    selbits: torch.Tensor, blocks: torch.Tensor, *, rows_per_block: int, class_words: int
) -> torch.Tensor:
    """AND of the selected rows of each class word: int32 [T, class_words].

    ``blocks`` is int32 [T, 128] holding uint32 bits: the gathered table
    block of each k-mer in the class-word-major device layout, so word
    ``l`` is row ``l % rows_per_block`` of class word
    ``l // rows_per_block``.  ``selbits`` is int32 [T, W] with
    ``W = max(1, rows_per_block // 32)``: bit ``r % 32`` of word
    ``r // 32`` selects row ``r``.  A row that is not selected counts as
    all-ones, so a k-mer with no selected row gives all-ones words.
    ``rows_per_block * class_words`` must be 128.
    """
    _check(selbits, blocks, rows_per_block, class_words)
    if blocks.device.type == "cpu":
        return probe_select_plain(
            selbits, blocks, rows_per_block=rows_per_block, class_words=class_words
        )
    if selbits.device != blocks.device:
        raise ValueError("selbits and blocks must share one device")
    selbits, blocks = selbits.contiguous(), blocks.contiguous()
    if blocks.data_ptr() % 16:  # the kernel loads 16 bytes a lane
        blocks = blocks.clone()
    out = torch.empty((blocks.shape[0], class_words), dtype=torch.int32, device=blocks.device)
    fn = _kernels.entry("probe_select")
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    rc = fn(
        selbits.data_ptr(), blocks.data_ptr(), out.data_ptr(), blocks.shape[0],
        rows_per_block, class_words, stream,
    )
    _kernels.check("probe_select", rc)
    probe_select.launches += 1
    return out


probe_select.launches = 0
