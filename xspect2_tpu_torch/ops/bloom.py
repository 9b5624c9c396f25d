"""Bit tests of a flat Bloom filter on the device: kernel K7.

:func:`bloom_count` (``csrc/bloom_count.cu``) is the device step of the
xxh3 compat genus filter (:mod:`xspect2_tpu_torch.core.compat`): the
host hashes the k-mers to bit positions, the device tests the bits.
:func:`bloom_count_plain` is the plain PyTorch version of the same
function; the wrapper uses it only for tensors on the CPU, and counts
its kernel launches in ``bloom_count.launches``.
"""

import torch

from xspect2_tpu_torch.core.hashing import MASK32
from xspect2_tpu_torch.ops import _kernels


def bloom_count_plain(words: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bloom_count`.

    Computes in int64 holding uint32 values (PyTorch has no uint32
    arithmetic on the CPU).
    """
    bits = pos.long() & MASK32
    word_idx = bits >> 5
    inside = word_idx < words.numel()
    word = (words.long() & MASK32)[torch.where(inside, word_idx, 0)]
    hit = (((word >> (bits & 31)) & 1).bool() & inside).all(dim=1) & valid.bool()
    return hit.sum().to(torch.int32).reshape(1)


def bloom_count(words: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Number of valid k-mers whose probe bits are all set: int32 [1].

    ``words`` is the filter as int32 [num_words] holding uint32 bit
    patterns (bit b of word w is filter bit ``32*w + b``), ``pos`` the
    probe bit positions as int32 [n, h], again uint32 bit patterns (so
    positions up to 2^32 - 1), ``valid`` bool or uint8 [n].  A position
    past the filter is a miss.  The result stays on the device.
    """
    if words.dtype != torch.int32 or words.dim() != 1 or not words.numel():
        raise ValueError("words must be a non-empty 1-D int32 tensor (uint32 bits)")
    if pos.dtype != torch.int32 or pos.dim() != 2 or pos.shape[1] < 1:
        raise ValueError("pos must be an int32 tensor [n, num_hashes] (uint32 bits)")
    if valid.dtype not in (torch.bool, torch.uint8) or tuple(valid.shape) != (pos.shape[0],):
        raise ValueError("valid must be a bool or uint8 tensor of one entry per k-mer")
    if words.device.type == "cpu":
        return bloom_count_plain(words, pos, valid)
    for t in (pos, valid):
        if t.device != words.device:
            raise ValueError("words, pos and valid must share one device")
    words, pos = words.contiguous(), pos.contiguous()
    valid = valid.contiguous().view(torch.uint8)
    out = torch.zeros(1, dtype=torch.int32, device=words.device)
    fn = _kernels.entry("bloom_count")
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = fn(
        words.data_ptr(), pos.data_ptr(), valid.data_ptr(), out.data_ptr(),
        pos.shape[0], pos.shape[1], words.numel(), stream,
    )
    _kernels.check("bloom_count", rc)
    bloom_count.launches += 1
    return out


bloom_count.launches = 0
