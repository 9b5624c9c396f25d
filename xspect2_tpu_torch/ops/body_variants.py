"""The read query's body formulations: kernel K10.

:func:`body_variants` (``csrc/body_variants.cu``) is the counterpart of
the seven jitted XLA programs of the JAX package's
``tools/microbench_body.py``.  Each pack, canonicalize and hash every
21-mer of a chunk of reads to a block and ``h`` rows, gather each
k-mer's whole 512 B block, and differ in how they select the probe rows
and count:

- ``current``: ``h`` passes, each keeping one row of the block and summing
  it out, then the AND of the passes; per-class counts from bit planes;
- ``reduceand``: one selected-row mask, unselected rows forced to all
  ones, one AND-reduce; bit planes;
- ``cwmajor``: ``reduceand`` over the class-word-major table; bit planes;
- ``cwmajor_p4``: ``cwmajor`` counting four classes a pass in byte lanes;
- ``noplanes`` and ``cwm_noplanes``: the AND-reduce, then the sum of the
  AND-ed words, no counting;
- ``gatheronly``: the sum of every gathered block word and every row id.

The four counting variants return int32 [N, C]: each read's hits per
class, equal to one another and to the read query's.  The three checksum
variants return, as ``make_scan`` does, one uint32 sum for each chunk of
``reads_per_chunk`` reads, broadcast to that chunk's rows (int32 [N, C]
holding uint32 bits).

:func:`body_variants_plain` is the plain PyTorch version of the same
functions, written as the tool's programs are; the wrapper uses it only
for tensors on the CPU, and counts its kernel launches in
``body_variants.launches``.  :func:`launch_config` reports the launch the
kernel library sizes for a read length.
"""

import ctypes

import torch

from xspect2_tpu_torch.core.hashing import MASK32, block_words_fieldbase_torch
from xspect2_tpu_torch.ops import _kernels
from xspect2_tpu_torch.ops.query import _canonical_windows_plain

VARIANTS = ("current", "reduceand", "cwmajor", "cwmajor_p4", "noplanes", "cwm_noplanes", "gatheronly")
COUNTING = VARIANTS[:4]
CLASS_WORD_MAJOR = ("cwmajor", "cwmajor_p4", "cwm_noplanes")
BLOCK_WORDS = 128
MAX_READ_LEN = 512
_PLAIN_READS = 512  # reads a pass of the plain version


def geometry(num_classes: int) -> tuple[int, int]:
    """``(class_words, rows_per_block)`` of the tool's table at
    ``num_classes`` classes (``tools/microbench_body.py:50-51``)."""
    class_words = max(1, (num_classes + 31) // 32)
    return class_words, max(8, BLOCK_WORDS // class_words)


def class_word_major(table: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The class-word-major copy of a row-major table that the tool builds
    for the ``cwmajor`` variants: word (w, row) of a block at
    ``w * rows_per_block + row``."""
    class_words, rows_per_block = geometry(num_classes)
    blocks = table.shape[0]
    return table.view(blocks, rows_per_block, class_words).transpose(1, 2).reshape(blocks, -1).contiguous()


def _check(variant, reads, table, num_classes, num_hashes, reads_per_chunk, k):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: expected one of {VARIANTS}")
    class_words, rows_per_block = geometry(num_classes)
    if num_classes < 1 or rows_per_block * class_words != BLOCK_WORDS or rows_per_block & (rows_per_block - 1):
        raise ValueError(
            f"{num_classes} classes give {class_words} class words and {rows_per_block} rows a block: "
            f"K10 takes blocks of {BLOCK_WORDS} words whose row count is a power of two (1, 2, 4, 8 or 16 "
            f"class words)"
        )
    if reads.dtype != torch.uint8 or reads.dim() != 2:
        raise ValueError("reads must be a uint8 tensor [N, L]")
    if not 1 <= k <= 32 or not k <= reads.shape[1] <= MAX_READ_LEN:
        raise ValueError(f"need 1 <= k <= 32 and k <= read length <= {MAX_READ_LEN}, not k={k}, L={reads.shape[1]}")
    if variant == "cwmajor_p4" and reads.shape[1] - k + 1 > 255:
        raise ValueError("cwmajor_p4 counts in byte lanes: a read must have fewer than 256 windows")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != BLOCK_WORDS or table.shape[0] < 1:
        raise ValueError(f"table must be an int32 tensor [num_blocks, {BLOCK_WORDS}] (uint32 bits)")
    if table.shape[0] >= 2**32:
        raise ValueError("a table of 2**32 blocks or more")
    if num_hashes < 1 or reads_per_chunk < 1:
        raise ValueError("num_hashes and reads_per_chunk must be positive")


def _and_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The bitwise AND over ``dim`` (a power-of-two length) of int64 words."""
    while x.shape[dim] > 1:
        half = x.shape[dim] // 2
        x = x.narrow(dim, 0, half) & x.narrow(dim, half, half)
    return x.squeeze(dim)


def _planes(anded: torch.Tensor, n_reads: int, num_classes: int) -> torch.Tensor:
    """``accum_planes``: AND-ed words [n_reads * nk, cw] -> int32 [n_reads, C]."""
    words = anded.view(n_reads, -1, anded.shape[1])
    out = torch.empty((n_reads, num_classes), dtype=torch.int32, device=anded.device)
    for w in range(anded.shape[1]):
        for c in range(min(32, num_classes - 32 * w)):
            out[:, 32 * w + c] = ((words[:, :, w] >> c) & 1).sum(dim=1)
    return out


def _planes4(anded: torch.Tensor, n_reads: int, num_classes: int) -> torch.Tensor:
    """``accum_planes4``: bits c, c+8, c+16, c+24 of a word in one pass, in
    byte lanes that never carry (fewer than 256 windows a read)."""
    words = anded.view(n_reads, -1, anded.shape[1])
    out = torch.empty((n_reads, num_classes), dtype=torch.int32, device=anded.device)
    for w in range(anded.shape[1]):
        nbits = min(32, num_classes - 32 * w)
        for c0 in range(min(8, nbits)):
            s = ((words[:, :, w] >> c0) & 0x01010101).sum(dim=1)
            for b in range(4):
                if c0 + 8 * b < nbits:
                    out[:, 32 * w + c0 + 8 * b] = (s >> (8 * b)) & 0xFF
    return out


def _body(variant, r, flat, num_blocks, class_words, rows_per_block, num_hashes, num_classes, k):
    """One pass of ``variant`` over int64 codes ``r`` [m, L]: int32 [m, C]
    counts, or the int64 sum of the pass (not yet wrapped)."""
    m = r.shape[0]
    nk = r.shape[1] - k + 1
    hi, lo, _ = _canonical_windows_plain(r, k, nk)
    block, rows, _ = block_words_fieldbase_torch(hi.reshape(-1), lo.reshape(-1), num_blocks, rows_per_block, num_hashes)
    blk = flat[block]  # [m * nk, 128]: each k-mer's whole block
    if variant == "gatheronly":
        return blk.sum() + rows.sum()
    nkm = blk.shape[0]
    ones = MASK32
    if variant == "current":
        lane_row = torch.arange(BLOCK_WORDS, device=r.device) // class_words
        anded = None
        for i in range(num_hashes):
            picked = torch.where(lane_row[None, :] == rows[:, i : i + 1], blk, 0)
            sel = picked.view(nkm, rows_per_block, class_words).sum(dim=1) & MASK32
            anded = sel if anded is None else anded & sel
    else:
        lane_row = torch.arange(rows_per_block, device=r.device)
        sel = torch.zeros((nkm, rows_per_block), dtype=torch.bool, device=r.device)
        for i in range(num_hashes):
            sel |= lane_row[None, :] == rows[:, i : i + 1]
        if variant in CLASS_WORD_MAJOR:
            masked = torch.where(sel[:, None, :], blk.view(nkm, class_words, rows_per_block), ones)
            anded = _and_reduce(masked, 2)
        else:
            selw = sel.repeat_interleave(class_words, dim=1)
            anded = _and_reduce(torch.where(selw, blk, ones).view(nkm, rows_per_block, class_words), 1)
        anded = anded.reshape(nkm, class_words)
    if variant in ("noplanes", "cwm_noplanes"):
        return anded.sum()
    if variant == "cwmajor_p4":
        return _planes4(anded, m, num_classes)
    return _planes(anded, m, num_classes)


def _broadcast_sums(sums: torch.Tensor, n: int, reads_per_chunk: int, num_classes: int) -> torch.Tensor:
    """Each chunk's sum on every row of that chunk: int32 [n, C]."""
    chunk = torch.arange(n, device=sums.device) // reads_per_chunk
    return sums[chunk][:, None].expand(n, num_classes)


def body_variants_plain(
    variant: str, reads: torch.Tensor, table: torch.Tensor, *, num_classes: int, num_hashes: int,
    reads_per_chunk: int, k: int = 21,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`body_variants`.

    Computes in int64 holding uint32 values masked with ``& 0xFFFFFFFF``
    (PyTorch has no uint32 ``+``, ``>>`` or ``<`` on the CPU), a pass of
    at most ``_PLAIN_READS`` reads of one chunk at a time; torch has no
    AND-reduction, so the AND over a block's rows is taken in halves.
    """
    _check(variant, reads, table, num_classes, num_hashes, reads_per_chunk, k)
    class_words, rows_per_block = geometry(num_classes)
    n = reads.shape[0]
    flat = table.long() & MASK32
    args = (flat, table.shape[0], class_words, rows_per_block, num_hashes, num_classes, k)
    if variant in COUNTING:
        out = torch.empty((n, num_classes), dtype=torch.int32, device=reads.device)
        for r0 in range(0, n, _PLAIN_READS):
            out[r0 : r0 + _PLAIN_READS] = _body(variant, reads[r0 : r0 + _PLAIN_READS].long(), *args)
        return out
    num_chunks = -(-n // reads_per_chunk)
    sums = torch.zeros(num_chunks, dtype=torch.int64, device=reads.device)
    for c in range(num_chunks):
        end = min(n, (c + 1) * reads_per_chunk)
        for r0 in range(c * reads_per_chunk, end, _PLAIN_READS):
            part = _body(variant, reads[r0 : min(end, r0 + _PLAIN_READS)].long(), *args)
            sums[c] = (sums[c] + part) & MASK32
    return _broadcast_sums(sums.to(torch.int32), n, reads_per_chunk, num_classes)


def body_variants(
    variant: str, reads: torch.Tensor, table: torch.Tensor, *, num_classes: int, num_hashes: int,
    reads_per_chunk: int, k: int = 21,
) -> torch.Tensor:
    """One formulation of the read query's body over uint8 ``reads`` [N, L].

    ``table`` is int32 [num_blocks, 128] (uint32 bits): row-major (the
    index's layout) for ``current``, ``reduceand``, ``noplanes`` and
    ``gatheronly``, class-word-major (:func:`class_word_major`) for the
    ``cwmajor`` variants; ``num_classes`` sets its class words and rows a
    block (:func:`geometry`).  Every window counts: a code above 3 packs
    as 0.  Returns int32 [N, C]: per-read class counts for the counting
    variants (:data:`COUNTING`), else each chunk's uint32 checksum on the
    chunk's rows; the last chunk may be partial.
    """
    _check(variant, reads, table, num_classes, num_hashes, reads_per_chunk, k)
    if reads.device.type == "cpu":
        return body_variants_plain(
            variant, reads, table, num_classes=num_classes, num_hashes=num_hashes,
            reads_per_chunk=reads_per_chunk, k=k,
        )
    if table.device != reads.device:
        raise ValueError("reads and table must share one device")
    reads, table = reads.contiguous(), table.contiguous()
    if table.data_ptr() % 16:  # the kernel loads 16 bytes a lane
        raise ValueError("the table must start at a 16-byte aligned address")
    class_words, rows_per_block = geometry(num_classes)
    n, read_len = reads.shape
    if variant in COUNTING:
        out = torch.empty((n, num_classes), dtype=torch.int32, device=reads.device)
    else:
        out = torch.zeros(max(1, -(-n // reads_per_chunk)), dtype=torch.int32, device=reads.device)
    if n:
        fn = _kernels.entry("body_variants")
        stream = torch.cuda.current_stream(reads.device).cuda_stream
        rc = fn(
            reads.data_ptr(), table.data_ptr(), out.data_ptr(), n, read_len, k, table.shape[0], rows_per_block,
            class_words, num_hashes, num_classes, reads_per_chunk, VARIANTS.index(variant), stream,
        )
        _kernels.check("body_variants", rc)
        body_variants.launches += 1
    return out if variant in COUNTING else _broadcast_sums(out, n, reads_per_chunk, num_classes)


body_variants.launches = 0

_CONFIG_KEYS = ("warps_a_block", "dynamic_smem_bytes", "blocks_an_sm", "sms", "optin_smem_bytes",
                "registers", "stages")


def launch_config(variant: str, read_len: int, num_classes: int, device=None) -> dict:
    """The launch :func:`body_variants` makes for ``variant`` at
    ``num_classes`` classes and ``read_len`` on a CUDA ``device`` (the
    current one by default), as the kernel library sizes it: warps a
    block, dynamic shared memory a block, blocks an SM, the card's SMs and
    opt-in shared memory a block, registers a thread, groups a warp stages.
    Launches nothing; raises on a device that is not CUDA."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: expected one of {VARIANTS}")
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("launch_config reports a CUDA launch: it needs a CUDA device")
    out = (ctypes.c_int * len(_CONFIG_KEYS))()
    with torch.cuda.device(device):
        rc = _kernels.entry("body_variants_config")(read_len, VARIANTS.index(variant), geometry(num_classes)[0], out)
    _kernels.check("body_variants", rc)
    return dict(zip(_CONFIG_KEYS, out))
