"""Uniform-read k-mer query on the device: the read wire, two kernels, the engine.

The read path of the JAX package (``xspect2_tpu/ops/query.py``) in
three steps:

1. :func:`pack_reads_wire` (host) 2-bit packs an [N, L] code matrix and
   lists the invalid bases as (row, column) patches;
2. :func:`unpack_2bit` (kernel K1, ``csrc/unpack_2bit.cu``) restores
   the [N, L] uint8 codes on the device;
3. :func:`reads_query` (kernel K2, ``csrc/reads_query.cu``) packs,
   canonicalizes and hashes every kept k-mer window, ANDs its probe
   words and counts per-read, per-class hits.

Each kernel wrapper has a plain PyTorch version of the same function
beside it.  The wrapper uses the plain version only for tensors on the
CPU (the tests); for a CUDA tensor it launches the kernel or raises.
Each wrapper counts its launches in its ``launches`` attribute.
"""

import numpy as np
import torch

from xspect2_tpu_torch import native, resolve_device
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.core.hashing import MASK32, kmer_hash_words_torch
from xspect2_tpu_torch.ops import _kernels

# reads per pass of the plain read query: bounds its int64 intermediates
_PLAIN_READS = 8192
# shared-memory bytes for K2's per-block (read, class) counters
_SHARED_COUNTER_BYTES = 32768
# kept windows handled by one K2 thread block
_WINDOWS_PER_BLOCK = 2048


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# ---------------------------------------------------------------- read wire


def pack_reads_wire(reads: np.ndarray, k: int, n_pad: int):
    """2-bit-pack a [N, L] code matrix for the packed device wire.

    Returns ``(packed [n_pad, ceil(L/4)], bad_rows, bad_cols)``: the
    packed payload padded to ``n_pad`` rows plus the invalid-base patch
    list ((read, base) int32 pairs; sentinel entries point one row past
    the end and are dropped by the unpack).  Padding rows are poisoned
    at every k-th base so each k-wide window holds an invalid base and
    counts no hit.
    """
    n, read_len = reads.shape
    packed, bad_flags = native.pack_2bit(reads)
    if n_pad != n:
        pad = np.zeros((n_pad - n, packed.shape[1]), dtype=np.uint8)
        packed = np.concatenate([packed, pad])
    flagged = np.nonzero(bad_flags)[0]
    if len(flagged):
        sub = reads[flagged].astype(np.uint8) > 3
        rr, cc = np.nonzero(sub)
        bad_rows = flagged[rr].astype(np.int32)
        bad_cols = cc.astype(np.int32)
    else:
        bad_rows = np.zeros(0, dtype=np.int32)
        bad_cols = np.zeros(0, dtype=np.int32)
    if n_pad != n:
        pad_rows = np.arange(n, n_pad, dtype=np.int32)
        offs = np.arange(0, read_len, k, dtype=np.int32)
        bad_rows = np.concatenate([bad_rows, np.repeat(pad_rows, len(offs))])
        bad_cols = np.concatenate([bad_cols, np.tile(offs, len(pad_rows))])
    bad_rows, bad_cols = _pad_patch_list((bad_rows, bad_cols), (n_pad, 0))
    return packed, bad_rows, bad_cols


def _pad_patch_list(arrays, sentinels):
    """Pad parallel int32 patch arrays to a power-of-two length.

    Keeps the JAX package's wire byte for byte; ``sentinels`` fill the
    tail (pointing past the data, so the unpack drops them).  Empty
    lists stay empty.
    """
    m = len(arrays[0])
    cap = _next_pow2(max(8, m)) if m else 0
    if not cap:
        return tuple(arrays)
    out = []
    for arr, sentinel in zip(arrays, sentinels):
        padded = np.full(cap, sentinel, dtype=np.int32)
        padded[:m] = arr
        out.append(padded)
    return tuple(out)


# ---------------------------------------------------------------- K1: unpack


def unpack_2bit_plain(
    packed: torch.Tensor, bad_rows: torch.Tensor, bad_cols: torch.Tensor, read_len: int
) -> torch.Tensor:
    """Plain PyTorch version of :func:`unpack_2bit`."""
    n, l4 = packed.shape
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=packed.device)
    codes = ((packed[:, :, None] >> shifts) & 3).reshape(n, l4 * 4)[:, :read_len]
    codes = codes.contiguous()
    rows = bad_rows.long()
    cols = bad_cols.long()
    keep = (rows >= 0) & (rows < n) & (cols >= 0) & (cols < read_len)
    codes[rows[keep], cols[keep]] = 255
    return codes


def unpack_2bit(
    packed: torch.Tensor, bad_rows: torch.Tensor, bad_cols: torch.Tensor, read_len: int
) -> torch.Tensor:
    """2-bit read wire -> uint8 codes [N, read_len], 255 at every patch.

    ``packed`` is uint8 [N, ceil(read_len/4)] with base b at bits
    ``2*(b%4)`` of byte ``b//4``; ``bad_rows``/``bad_cols`` are int32
    patch lists whose entries outside the matrix are dropped.
    """
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError("packed must be a 2-D uint8 tensor")
    if bad_rows.dtype != torch.int32 or bad_cols.dtype != torch.int32:
        raise ValueError("patch lists must be int32")
    if bad_rows.shape != bad_cols.shape or bad_rows.dim() != 1:
        raise ValueError("patch lists must be 1-D and of equal length")
    n, l4 = packed.shape
    if l4 != -(-read_len // 4):
        raise ValueError(f"packed width {l4} does not fit read_len {read_len}")
    if packed.device.type == "cpu":
        return unpack_2bit_plain(packed, bad_rows, bad_cols, read_len)
    for t in (bad_rows, bad_cols):
        if t.device != packed.device:
            raise ValueError("packed and patch lists must share one device")
    packed = packed.contiguous()
    bad_rows = bad_rows.contiguous()
    bad_cols = bad_cols.contiguous()
    codes = torch.empty((n, read_len), dtype=torch.uint8, device=packed.device)
    fn = _kernels.entry("unpack_2bit")
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = fn(
        packed.data_ptr(), codes.data_ptr(), bad_rows.data_ptr(), bad_cols.data_ptr(),
        n, l4, read_len, bad_rows.numel(), stream,
    )
    _kernels.check("unpack_2bit", rc)
    unpack_2bit.launches += 1
    return codes


unpack_2bit.launches = 0


# ---------------------------------------------------------------- K2: read query


def count_dtype(read_len: int, k: int, step: int) -> torch.dtype:
    """uint8 when a per-read count fits (<= 255 kept windows), else int32."""
    return torch.uint8 if -(-(read_len - k + 1) // step) <= 0xFF else torch.int32


def _check_geometry(codes, table, k, step, num_blocks, rows_per_block, class_words,
                    num_hashes, fields_per_word, num_classes):
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("codes must be a 2-D uint8 tensor")
    if table.dtype != torch.int32 or table.dim() != 2:
        raise ValueError("table must be a 2-D int32 tensor (uint32 bits)")
    if not 1 <= k <= 32:
        raise ValueError("k must be in [1, 32]")
    if step < 1 or num_hashes < 1:
        raise ValueError("step and num_hashes must be >= 1")
    if codes.shape[1] < k:
        raise ValueError("reads must be at least k bases long")
    if rows_per_block & (rows_per_block - 1) or fields_per_word & (fields_per_word - 1):
        raise ValueError("rows_per_block and fields_per_word must be powers of two")
    if tuple(table.shape) != (num_blocks, class_words * rows_per_block):
        raise ValueError(
            f"table shape {tuple(table.shape)} does not match "
            f"[{num_blocks}, {class_words * rows_per_block}]"
        )
    if fields_per_word > 1 and (class_words != 1 or num_classes * fields_per_word > 32):
        raise ValueError("field packing needs all classes in one word")
    if not 0 < num_classes <= 32 * class_words:
        raise ValueError("num_classes does not fit class_words")
    if _counter_rows(num_classes) < 3:
        raise ValueError(
            f"{num_classes} classes exceed reads_query's shared counters "
            f"({_SHARED_COUNTER_BYTES} bytes hold 3 reads of at most "
            f"{_SHARED_COUNTER_BYTES // 12} classes)"
        )


def _counter_rows(num_classes: int) -> int:
    """Reads whose (read, class) counters fit K2's shared-memory budget."""
    return _SHARED_COUNTER_BYTES // (4 * num_classes)


def reads_query_plain(
    codes: torch.Tensor,
    table: torch.Tensor,
    *,
    k: int,
    step: int,
    num_blocks: int,
    rows_per_block: int,
    class_words: int,
    num_hashes: int,
    fields_per_word: int,
    num_classes: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`reads_query`: int32 [N, C] hit counts.

    Computes in int64 holding uint32 values (PyTorch has no uint32
    shifts or sums on the CPU), a pass of at most ``_PLAIN_READS`` reads
    at a time.
    """
    n, read_len = codes.shape
    nk = read_len - k + 1
    lo_bases = min(k, 16)
    hi_bases = k - lo_bases
    rpb = rows_per_block
    P = fields_per_word
    fb = 32 // P
    flat = table.reshape(-1).long() & MASK32
    out = torch.zeros((n, num_classes), dtype=torch.int32, device=codes.device)
    for r0 in range(0, n, _PLAIN_READS):
        r = codes[r0 : r0 + _PLAIN_READS].long()
        m = r.shape[0]
        f_hi = torch.zeros((m, nk), dtype=torch.int64, device=codes.device)
        f_lo = torch.zeros_like(f_hi)
        r_hi = torch.zeros_like(f_hi)
        r_lo = torch.zeros_like(f_hi)
        bad = torch.zeros((m, nk), dtype=torch.bool, device=codes.device)
        for j in range(k):
            c = r[:, j : j + nk]
            bad |= c > 3
            cm = torch.where(c > 3, 0, c)
            if j < hi_bases:
                f_hi = (f_hi << 2) | cm
            else:
                f_lo = (f_lo << 2) | cm
        # base t of the reverse complement is comp(code[k-1-t])
        for t in range(k):
            c = r[:, k - 1 - t : k - 1 - t + nk]
            cm = torch.where(c > 3, 0, 3 - c)
            if t < hi_bases:
                r_hi = (r_hi << 2) | cm
            else:
                r_lo = (r_lo << 2) | cm
        fwd_le = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
        hi = torch.where(fwd_le, f_hi, r_hi)[:, ::step].reshape(-1)
        lo = torch.where(fwd_le, f_lo, r_lo)[:, ::step].reshape(-1)
        ok = ~bad[:, ::step]
        nkk = ok.shape[1]

        a, b, c = kmer_hash_words_torch(hi, lo)
        base = (a % num_blocks) * (class_words * rpb)
        if P == 1:
            words = []
            for w in range(class_words):
                acc = torch.full_like(a, MASK32)
                for i in range(num_hashes):
                    row = ((b + i * c) & MASK32) & (rpb - 1)
                    acc &= flat[base + w * rpb + row]
                words.append(acc)
        else:
            g = (b >> 24) & (P - 1)
            acc = torch.full_like(a, MASK32)
            for s in range(min(num_hashes, P)):
                slot = torch.full_like(a, MASK32)
                for i in range(s, num_hashes, P):
                    slot &= flat[base + (((b + i * c) & MASK32) & (rpb - 1))]
                rot = ((g + s) & (P - 1)) * fb
                slot = ((slot >> rot) | (slot << ((32 - rot) & 31))) & MASK32
                acc &= slot
            words = [acc & ((1 << fb) - 1)]
        counts = out[r0 : r0 + m]
        for w, word in enumerate(words):
            word = torch.where(ok.reshape(-1), word, 0).reshape(m, nkk)
            for bit in range(min(32, num_classes - 32 * w)):
                counts[:, 32 * w + bit] = ((word >> bit) & 1).sum(dim=1).int()
    return out


def reads_query(
    codes: torch.Tensor,
    table: torch.Tensor,
    *,
    k: int,
    step: int,
    num_blocks: int,
    rows_per_block: int,
    class_words: int,
    num_hashes: int,
    fields_per_word: int,
    num_classes: int,
) -> torch.Tensor:
    """Per-read, per-class hit counts of uniform reads: [N, C].

    ``codes`` is uint8 [N, L] (>3 = invalid base), ``table`` the index's
    device layout (:meth:`BlockedBitSlicedIndex.device_table`) as int32
    [num_blocks, class_words * rows_per_block].  Windows
    ``0, step, 2*step, ...`` of each read are counted; a window holding
    an invalid base counts nothing.  The result is uint8 when every
    count fits (``ceil((L-k+1)/step) <= 255``), else int32.
    """
    geom = dict(
        k=k, step=step, num_blocks=num_blocks, rows_per_block=rows_per_block,
        class_words=class_words, num_hashes=num_hashes,
        fields_per_word=fields_per_word, num_classes=num_classes,
    )
    _check_geometry(codes, table, **geom)
    n, read_len = codes.shape
    dtype = count_dtype(read_len, k, step)
    if codes.device.type == "cpu":
        return reads_query_plain(codes, table, **geom).to(dtype)
    if table.device != codes.device:
        raise ValueError("codes and table must share one device")
    codes = codes.contiguous()
    table = table.contiguous()
    nkk = -(-(read_len - k + 1) // step)
    # a block's windows span at most (wpb-1)//nkk + 2 reads, whose
    # counters must fit the shared-memory budget
    wpb = min(_WINDOWS_PER_BLOCK, (_counter_rows(num_classes) - 2) * nkk + 1)
    max_reads = (wpb - 1) // nkk + 2
    out = torch.zeros((n, num_classes), dtype=torch.int32, device=codes.device)
    fn = _kernels.entry("reads_query")
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = fn(
        codes.data_ptr(), table.data_ptr(), out.data_ptr(), n, read_len, k, step,
        num_blocks, rows_per_block, class_words, num_hashes, fields_per_word,
        num_classes, wpb, max_reads, stream,
    )
    _kernels.check("reads_query", rc)
    reads_query.launches += 1
    return out.to(dtype)


reads_query.launches = 0


# ---------------------------------------------------------------- engine


class DeviceQueryEngine:
    """Holds an index table resident on the device and queries reads."""

    def __init__(self, index: BlockedBitSlicedIndex, device=None):
        self.index = index
        self.device = resolve_device(device)
        self.table = torch.from_numpy(index.device_table().view(np.int32)).to(self.device)

    def geometry(self) -> dict:
        """The index geometry as :func:`reads_query` takes it."""
        idx = self.index
        return dict(
            k=idx.k,
            num_blocks=int(idx.num_blocks),
            rows_per_block=idx.rows_per_block,
            class_words=idx.class_words,
            num_hashes=idx.num_hashes,
            fields_per_word=idx.fields_per_word,
            num_classes=idx.num_classes,
        )

    def upload_wire(self, reads: np.ndarray, reads_per_chunk: int = 4096):
        """The packed wire of :meth:`count_hits_reads` on the device:
        ``(packed, bad_rows, bad_cols)``, rows padded to a whole number
        of ``reads_per_chunk``."""
        n_pad = -(-len(reads) // reads_per_chunk) * reads_per_chunk
        wire = pack_reads_wire(reads, self.index.k, n_pad)
        return tuple(torch.from_numpy(a).to(self.device) for a in wire)

    def count_hits_reads(
        self,
        reads: np.ndarray,
        step: int = 1,
        reads_per_chunk: int = 4096,
        block: bool = True,
        wire: str = "packed",
    ):
        """Uniform-read query: [N, L] uint8 code matrix -> [N, C] hits.

        Reads are padded to a whole number of ``reads_per_chunk``.  With
        ``block=False`` the padded device tensor is returned without
        synchronizing, so a caller can queue several batches.  ``wire``
        selects the host->device format: "packed" (2-bit codes and a
        patch list, 4x fewer bytes) or "raw" (one byte per base).
        """
        if wire not in ("packed", "raw"):
            raise ValueError(f"unknown wire format {wire!r}: expected 'packed' or 'raw'")
        n, read_len = reads.shape
        n_pad = -(-n // reads_per_chunk) * reads_per_chunk
        if wire == "packed":
            codes = unpack_2bit(*self.upload_wire(reads, reads_per_chunk), read_len)
        else:
            if n_pad != n:
                pad = np.full((n_pad - n, read_len), 255, dtype=np.uint8)
                reads = np.concatenate([reads, pad])
            codes = torch.from_numpy(np.ascontiguousarray(reads, dtype=np.uint8)).to(
                self.device
            )
        out = reads_query(codes, self.table, step=step, **self.geometry())
        if not block:
            return out
        return out[:n].cpu().numpy().astype(np.int64)
