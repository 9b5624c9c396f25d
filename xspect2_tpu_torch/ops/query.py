"""k-mer query on the device: the wires, six kernels, the engine.

Three paths of the JAX package (``xspect2_tpu/ops/query.py``):

Uniform reads (the FASTQ path):

1. :func:`pack_reads_wire` (host) 2-bit packs an [N, L] code matrix and
   lists the invalid bases as (row, column) patches;
2. :func:`unpack_2bit` (kernel K1, ``csrc/unpack_2bit.cu``) restores
   the [N, L] uint8 codes and their invalid-base patches on the device
   in one launch;
3. :func:`reads_query` (kernel K2, ``csrc/reads_query.cu``) stages the
   codes 2-bit packed, canonicalizes and hashes every kept k-mer window,
   ANDs its probe words and counts per-read, per-class hits.

Ragged records (assemblies, record lists):

1. :func:`prepare_batch` (host) flattens records into one position
   stream padded to a power-of-two number of chunks
   (:class:`PreparedBatch`); :func:`packed_wire_for_batch` 2-bit packs
   it with a flat invalid-base patch list and the record offsets;
2. :func:`restore_batch` uploads that wire and
   :func:`restore_records_wire` (kernel K4, ``csrc/records_wire.cu``)
   restores the codes, each position's record id and its window
   validity in one launch;
3. :func:`records_query` (kernel K3, ``csrc/records_query.cu``) counts
   per-record, per-class hits of every valid window.  The raw wire
   ships codes, record ids and validity and goes to K3 directly.

Several indices over one batch (MLST strain typing, one index per
locus; :func:`make_multi_packed_query`):

1. K4 restores codes, record ids and validity from the compact wire
   once;
2. :func:`multi_records_query` (kernel K5,
   ``csrc/multi_records_query.cu``) counts per-record, per-class hits
   against every table, in one launch per probe path among them;
3. :func:`reduce_record_counts` (kernel K6, ``csrc/segment_reduce.cu``)
   reduces the counts over the records on the device (thresholded
   totals, the first record, or thresholded totals per segment), so the
   fetch is [C] or [num_segments, C] per index.

Each kernel wrapper has a plain PyTorch version of the same function
beside it.  The wrapper uses the plain version only for tensors on the
CPU (the tests); for a CUDA tensor it launches the kernel or raises.
Each wrapper counts its launches in its ``launches`` attribute.

The host packing of a wire, the launches of a records query and its
fetch are timed as the phases ``query.pack``, ``query.dispatch`` and
``query.sync`` of :mod:`xspect2_tpu_torch.profiling`, where the JAX
package's engine times them.
"""

import ctypes
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from xspect2_tpu_torch import native, profiling, resolve_device
from xspect2_tpu_torch.core.blocked_index import BlockedBitSlicedIndex
from xspect2_tpu_torch.core.dna import INVALID
from xspect2_tpu_torch.core.hashing import MASK32, kmer_hash_words_torch
from xspect2_tpu_torch.ops import _kernels

# positions per chunk of a prepared batch (the JAX package's default)
DEFAULT_CHUNK = 1 << 16
# reads per pass of the plain read query: bounds its int64 intermediates
_PLAIN_READS = 8192
# positions per pass of the plain records query, for the same reason
_PLAIN_POSITIONS = 1 << 20
# shared-memory bytes for K2's per-block (read, class) and K3's
# per-block (record, class) counters
_SHARED_COUNTER_BYTES = 32768
# kept windows handled by one K2 thread block, positions by one K3, K5
# or K7 block; also the most flat positions a K2 block's windows may
# start at (kMaxBlockPositions of csrc/records_block.cuh: the code stage)
_WINDOWS_PER_BLOCK = 2048
# record slots summed by one K6 thread block
_REDUCE_ROWS = 32


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


# ---------------------------------------------------------------- records batch


@dataclass
class PreparedBatch:
    """Host-prepared flat batch of records for one device query call."""

    codes: np.ndarray  # uint8 [num_positions + k - 1]
    num_positions: int  # a power-of-two number of chunks, padding included
    record_names: list[str] = field(default_factory=list)
    num_kmers: list[int] = field(default_factory=list)  # per record, ceil((len-k+1)/step)
    # record start positions in the flat code tensor ([num_records + 1],
    # last entry = total real bases); the compact wire derives rec_ids
    # and validity on the device from these.  None for fixed batches.
    offsets: np.ndarray | None = None
    # sparse-sampling step baked into ``valid`` as a MASK (each record's
    # phase restarts at its own offset), so it does not reduce the
    # positions the device visits
    step: int = 1
    # the raw wire's per-position arrays (:attr:`rec_ids`, :attr:`valid`):
    # given by a fixed batch, else made from the offsets on first read
    _rec_ids: np.ndarray | None = field(default=None, repr=False, compare=False)
    _valid: np.ndarray | None = field(default=None, repr=False, compare=False)
    # device tensors of the compact wire, keyed by (max_records, device):
    # engines querying the same batch share one pack and one copy
    _device_wire: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def num_records(self) -> int:
        return len(self.record_names)

    @property
    def k(self) -> int:
        """The k the batch was prepared at (its codes end in a k-1 halo)."""
        return len(self.codes) - self.num_positions + 1

    @property
    def max_records(self) -> int:
        """Record slots of its device counts: the record count up to a power of two, >= 8."""
        return _next_pow2(max(8, self.num_records))

    @property
    def min_record_len(self) -> int | None:
        """The shortest record, the counting kernels' block-sizing hint (None without offsets)."""
        return None if self.offsets is None else int(np.diff(self.offsets).min())

    @property
    def rec_ids(self) -> np.ndarray:
        """int32 [num_positions]: each position's record, 0 on padding."""
        if self._rec_ids is None:
            self._make_position_arrays()
        return self._rec_ids

    @property
    def valid(self) -> np.ndarray:
        """bool [num_positions]: whether a k-mer window of the position's
        record starts there on the record's sparse-sampling phase."""
        if self._valid is None:
            self._make_position_arrays()
        return self._valid

    def _make_position_arrays(self) -> None:
        lengths = np.diff(self.offsets)
        n_real = int(self.offsets[-1])
        owner = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
        rel = np.arange(n_real, dtype=np.int64) - self.offsets[owner]
        self._rec_ids = np.zeros(self.num_positions, dtype=np.int32)
        self._rec_ids[:n_real] = owner
        self._valid = np.zeros(self.num_positions, dtype=bool)
        self._valid[:n_real] = (rel <= (lengths - self.k)[owner]) & (rel % self.step == 0)


def padded_positions(n_pos: int, chunk: int = DEFAULT_CHUNK) -> int:
    """Positions of a batch's flat code tensor for ``n_pos`` bases, its k-1
    halo aside: a power-of-two number of ``chunk``-sized chunks, at least one."""
    return _next_pow2(max(1, -(-n_pos // chunk))) * chunk


def pad_codes(codes: np.ndarray, k: int, chunk: int = DEFAULT_CHUNK) -> np.ndarray:
    """Records' codes laid end to end, as a batch's flat code tensor:
    :func:`padded_positions` plus a k-1 halo, the padding invalid."""
    n_pos = len(codes)
    n_pad = padded_positions(n_pos, chunk)
    padded = np.full(n_pad + k - 1, INVALID, dtype=np.uint8)
    padded[:n_pos] = codes
    return padded


def batch_from_flat(padded: np.ndarray, offsets: np.ndarray, names: list[str], k: int,
                    step: int = 1) -> PreparedBatch:
    """A :class:`PreparedBatch` of records laid end to end in ``padded``
    (:func:`pad_codes`): record r spans ``[offsets[r], offsets[r + 1])``,
    ``offsets[0]`` is 0.  Every record must be strictly longer than k."""
    lengths = np.diff(offsets)
    if (lengths <= k).any():
        raise ValueError("Invalid sequence, must be longer than k")
    num_kmers = ((lengths - k + step) // step).tolist()
    return PreparedBatch(padded, len(padded) - (k - 1), list(names), num_kmers,
                         offsets.astype(np.int32), step)


def prepare_batch(records, k: int, step: int = 1, chunk: int = DEFAULT_CHUNK):
    """Flatten ``(name, codes_uint8)`` records into a :class:`PreparedBatch`.

    Every record must be strictly longer than k.  The position axis is
    padded to a power-of-two number of ``chunk``-sized chunks, plus a
    k-1 halo of invalid codes; padding positions have record id 0 and
    are never valid.
    """
    names = []
    parts = []
    for name, codes in records:
        names.append(name)
        parts.append(codes)
    offsets = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in parts], out=offsets[1:])
    codes = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
    return batch_from_flat(pad_codes(codes, k, chunk), offsets, names, k, step)


def prepare_fixed_batch(
    codes_matrix: np.ndarray, k: int, step: int = 1, chunk: int = DEFAULT_CHUNK
) -> PreparedBatch:
    """:func:`prepare_batch` for N equal-length reads ([N, L]), vectorized.

    The batch carries no offsets, so it travels on the raw wire.
    """
    n, length = codes_matrix.shape
    if not length > k:
        raise ValueError("Invalid sequence, must be longer than k")
    nk = length - k + 1
    n_pos = n * length
    n_pad = padded_positions(n_pos, chunk)

    codes = np.full(n_pad + k - 1, INVALID, dtype=np.uint8)
    codes[:n_pos] = codes_matrix.reshape(-1)
    rec_ids = np.zeros(n_pad, dtype=np.int32)
    rec_ids[:n_pos] = np.repeat(np.arange(n, dtype=np.int32), length)
    valid_row = np.zeros(length, dtype=bool)
    valid_row[0:nk:step] = True
    valid = np.zeros(n_pad, dtype=bool)
    valid[:n_pos] = np.broadcast_to(valid_row, (n, length)).reshape(-1)
    return PreparedBatch(
        codes, n_pad, [f"read{i}" for i in range(n)], [math.ceil(nk / step)] * n,
        _rec_ids=rec_ids, _valid=valid,
    )


def packed_wire_for_batch(batch: PreparedBatch, max_records: int):
    """Compact device wire of a prepared batch: ``(packed, bad_pos, offsets)``.

    2-bit packed codes (uint8 [ceil(len(codes)/4)]), the positions of
    the real records' invalid bases padded to a power of two with the
    sentinel ``len(batch.codes)`` (one past the flat code tensor, so the
    unpack drops it), and the offsets padded to ``max_records + 1``
    entries with the total real base count.  Padding positions are not
    patched: no valid window reads them.
    """
    with profiling.phase("query.pack"):
        packed, _bad = native.pack_2bit(batch.codes[None, :])
        packed = packed.reshape(-1)
        n_real = int(batch.offsets[-1])
        bad_pos = np.nonzero(batch.codes[:n_real].astype(np.uint8) > 3)[0].astype(np.int32)
        (bad_pos,) = _pad_patch_list((bad_pos,), (len(batch.codes),))
        offsets = np.full(max_records + 1, n_real, dtype=np.int32)
        offsets[: len(batch.offsets)] = batch.offsets
    return packed, bad_pos, offsets


def upload_patch_list(patches: np.ndarray, device) -> torch.Tensor:
    """An int32 patch list (``bad_rows`` of the read wire, ``bad_pos`` of
    the records wire) as a tensor on ``device``, marked as ascending when
    it never decreases.  The order is checked here, on the host, where the
    wire is made: K1 and K4 set the patches of a marked list in the same
    launch as the unpack, and take a second, patch-only launch for any
    other list, or for a marked one changed in place since."""
    t = torch.from_numpy(np.ascontiguousarray(patches)).to(device)
    if bool(np.all(patches[1:] >= patches[:-1])):
        t._ascending_at = t._version
    return t


def _ascending(patches: torch.Tensor) -> bool:
    """Whether :func:`upload_patch_list` found ``patches`` ascending and it
    is unchanged since."""
    return getattr(patches, "_ascending_at", None) == patches._version


def wire_to_device(wire, device):
    """A wire's host arrays on ``device``: ``(packed, bad_rows, bad_cols)``
    of :func:`pack_reads_wire` or ``(packed, bad_pos, offsets)`` of
    :func:`packed_wire_for_batch`, the patch list (the second) through
    :func:`upload_patch_list`."""
    packed, patches, rest = wire
    return (torch.from_numpy(packed).to(device), upload_patch_list(patches, device),
            torch.from_numpy(rest).to(device))


def upload_records_wire(batch: PreparedBatch, max_records: int, device):
    """The compact wire of a prepared batch (:func:`packed_wire_for_batch`)
    as tensors on ``device`` (:func:`wire_to_device`), cached on the batch."""
    key = (max_records, str(device))
    dev = batch._device_wire.get(key)
    if dev is None:
        dev = wire_to_device(packed_wire_for_batch(batch, max_records), device)
        batch._device_wire[key] = dev
    return dev


def restore_batch(batch: PreparedBatch, device):
    """A prepared batch's ``(codes, rec_ids, valid)`` on ``device``: its compact
    wire uploaded at :attr:`PreparedBatch.max_records` (:func:`upload_records_wire`,
    cached on the batch) and restored by K4 at the batch's positions, k and step."""
    packed, bad_pos, offsets = upload_records_wire(batch, batch.max_records, device)
    return restore_records_wire(
        packed, bad_pos, offsets, batch.num_positions, k=batch.k, step=batch.step
    )


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
    patch lists whose entries outside the matrix are dropped.  K1 sets
    the patches in the same launch as the unpack when ``bad_rows`` was
    uploaded by :func:`upload_patch_list` and found ascending there, as
    every list :func:`pack_reads_wire` builds is; any other list takes a
    second, patch-only launch.
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
    ascending = _ascending(bad_rows)
    packed = _aligned(packed, "packed")
    bad_rows = bad_rows.contiguous()
    bad_cols = bad_cols.contiguous()
    m = bad_rows.numel()
    codes = torch.empty((n, read_len), dtype=torch.uint8, device=packed.device)
    fn = _kernels.entry("unpack_2bit")
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = fn(
        packed.data_ptr(), codes.data_ptr(), bad_rows.data_ptr(), bad_cols.data_ptr(),
        n, l4, read_len, m, int(ascending), stream,
    )
    _kernels.check("unpack_2bit", rc)
    if codes.numel():
        unpack_2bit.launches += 1 if ascending or not m else 2
    return codes


unpack_2bit.launches = 0


# ---------------------------------------------------------------- K2: read query


def count_dtype(read_len: int, k: int, step: int) -> torch.dtype:
    """uint8 when a per-read count fits (<= 255 kept windows), else int32."""
    return torch.uint8 if -(-(read_len - k + 1) // step) <= 0xFF else torch.int32


def _check_table_geometry(table, k, num_blocks, rows_per_block, class_words,
                          num_hashes, fields_per_word, num_classes,
                          local_blocks=None, block_offset=0):
    if table.dtype != torch.int32 or table.dim() != 2:
        raise ValueError("table must be a 2-D int32 tensor (uint32 bits)")
    if not 1 <= k <= 32:
        raise ValueError("k must be in [1, 32]")
    if num_hashes < 1:
        raise ValueError("num_hashes must be >= 1")
    if rows_per_block & (rows_per_block - 1) or fields_per_word & (fields_per_word - 1):
        raise ValueError("rows_per_block and fields_per_word must be powers of two")
    table_blocks = num_blocks
    if local_blocks is not None:
        # below 2**31 the kernels' unsigned `block - block_offset` cannot
        # wrap back into the window
        if not (0 < local_blocks < 1 << 31 and 0 <= block_offset < 1 << 31):
            raise ValueError(
                f"owned-block mode needs 0 < local_blocks < 2**31 and 0 <= block_offset "
                f"< 2**31, not local_blocks={local_blocks}, block_offset={block_offset}"
            )
        table_blocks = local_blocks
    elif block_offset:
        raise ValueError("block_offset needs local_blocks (the owned-block mode)")
    if tuple(table.shape) != (table_blocks, class_words * rows_per_block):
        raise ValueError(
            f"table shape {tuple(table.shape)} does not match "
            f"[{table_blocks}, {class_words * rows_per_block}]"
        )
    if fields_per_word > 1 and (class_words != 1 or num_classes * fields_per_word > 32):
        raise ValueError("field packing needs all classes in one word")
    if not 0 < num_classes <= 32 * class_words:
        raise ValueError("num_classes does not fit class_words")


def _check_geometry(codes, table, k, step, num_blocks, rows_per_block, class_words,
                    num_hashes, fields_per_word, num_classes,
                    local_blocks=None, block_offset=0):
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("codes must be a 2-D uint8 tensor")
    if step < 1:
        raise ValueError("step must be >= 1")
    _check_table_geometry(table, k, num_blocks, rows_per_block, class_words,
                          num_hashes, fields_per_word, num_classes,
                          local_blocks, block_offset)
    if codes.shape[1] < k:
        raise ValueError("reads must be at least k bases long")
    if _counter_rows(num_classes) < 3:
        raise ValueError(
            f"{num_classes} classes exceed reads_query's shared counters "
            f"({_SHARED_COUNTER_BYTES} bytes hold 3 reads of at most "
            f"{_SHARED_COUNTER_BYTES // 12} classes)"
        )


def table_tensor(index: BlockedBitSlicedIndex, device) -> torch.Tensor:
    """The index's table on ``device`` as the query kernels take it: a
    copy of ``index.table`` in its own row-major layout, int32 (uint32
    bits) [num_blocks, rows_per_block * class_words], so one probe row is
    ``class_words`` contiguous words."""
    words = np.asarray(index.table).view(np.int32).reshape(index.num_blocks, -1)
    return torch.tensor(words, device=device)


def _aligned(t: torch.Tensor, what: str = "the table") -> torch.Tensor:
    """``t`` contiguous; it must be 16-byte aligned, since the kernels read
    it (probe rows, packed wire bytes) with vector loads."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must start at a 16-byte aligned address")
    return t


def _counter_rows(num_classes: int) -> int:
    """Reads (K2) or records (K3) whose per-class counters fit the
    shared-memory budget of one thread block."""
    return _SHARED_COUNTER_BYTES // (4 * num_classes)


def _window_span(m: int, read_len: int, step: int, nkk: int) -> int:
    """The most flat positions from the first to the last of ``m + 1``
    consecutive kept windows of [N, read_len] reads (``nkk`` kept a read),
    wherever they start: ``q`` whole reads and ``s`` more windows; when
    ``s > 0`` the last may lie past a read boundary, which costs
    ``read_len - nkk * step`` more than the stride when that is positive."""
    q, s = divmod(m, nkk)
    return q * read_len + s * step + (max(0, read_len - nkk * step) if s else 0)


def _reads_block(read_len: int, k: int, step: int, num_classes: int) -> tuple[int, int]:
    """``(windows_per_block, max_reads)`` of K2's thread blocks.

    A block's ``wpb`` kept windows span at most ``(wpb-1)//nkk + 2``
    reads, whose counters must fit its shared memory, and their flat
    start positions at most ``_WINDOWS_PER_BLOCK`` positions, whose codes
    the block stages (``csrc/records_block.cuh``), for every ``read_len``,
    ``k`` and ``step``.  The counts do not depend on the choice.
    """
    nkk = -(-(read_len - k + 1) // step)
    wpb = min(_WINDOWS_PER_BLOCK, (_counter_rows(num_classes) - 2) * nkk + 1)
    lo, hi = 1, wpb  # the largest wpb in [lo, hi] whose span fits the stage
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _window_span(mid - 1, read_len, step, nkk) < _WINDOWS_PER_BLOCK:
            lo = mid
        else:
            hi = mid - 1
    return lo, (lo - 1) // nkk + 2


def _canonical_windows_plain(codes: torch.Tensor, k: int, nk: int):
    """Canonical (hi, lo) words and the invalid flag of windows 0..nk-1
    of each row of int64 ``codes`` [m, >= nk + k - 1]: ([m, nk],) * 3."""
    lo_bases = min(k, 16)
    hi_bases = k - lo_bases
    m = codes.shape[0]
    f_hi = torch.zeros((m, nk), dtype=torch.int64, device=codes.device)
    f_lo = torch.zeros_like(f_hi)
    r_hi = torch.zeros_like(f_hi)
    r_lo = torch.zeros_like(f_hi)
    bad = torch.zeros((m, nk), dtype=torch.bool, device=codes.device)
    for j in range(k):
        c = codes[:, j : j + nk]
        bad |= c > 3
        cm = torch.where(c > 3, 0, c)
        if j < hi_bases:
            f_hi = (f_hi << 2) | cm
        else:
            f_lo = (f_lo << 2) | cm
    # base t of the reverse complement is comp(code[k-1-t])
    for t in range(k):
        c = codes[:, k - 1 - t : k - 1 - t + nk]
        cm = torch.where(c > 3, 0, 3 - c)
        if t < hi_bases:
            r_hi = (r_hi << 2) | cm
        else:
            r_lo = (r_lo << 2) | cm
    fwd_le = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
    return torch.where(fwd_le, f_hi, r_hi), torch.where(fwd_le, f_lo, r_lo), bad


def _and_words_plain(hi, lo, flat, *, num_blocks, rows_per_block, class_words,
                     num_hashes, fields_per_word, local_blocks=None, block_offset=0):
    """The AND of each k-mer's probe words: one int64 word per class word
    (masked to the field width when P > 1).  ``flat`` is the row-major
    table (:func:`table_tensor`) flattened: word ``w`` of row ``r`` of
    block ``b`` at ``(b * rows_per_block + r) * class_words + w``.

    In owned-block mode (``local_blocks`` set) ``flat`` holds only the
    ``local_blocks`` blocks from ``block_offset`` on; a k-mer whose block
    lies outside that window reads a clamped block and its words are
    forced to 0, so the words of all shards OR (and their counts sum) to
    the unsharded ones.
    """
    rpb = rows_per_block
    P = fields_per_word
    fb = 32 // P
    a, b, c = kmer_hash_words_torch(hi, lo)
    block = a % num_blocks
    owned = None
    if local_blocks is not None:
        local = block - block_offset
        owned = (local >= 0) & (local < local_blocks)
        block = local.clamp(0, local_blocks - 1)
    base = block * (rpb * class_words)
    if P == 1:
        rows = [base + (((b + i * c) & MASK32) & (rpb - 1)) * class_words for i in range(num_hashes)]
        words = []
        for w in range(class_words):
            acc = torch.full_like(a, MASK32)
            for row in rows:
                acc &= flat[row + w]
            words.append(acc if owned is None else torch.where(owned, acc, 0))
        return words
    g = (b >> 24) & (P - 1)
    acc = torch.full_like(a, MASK32)
    for s in range(min(num_hashes, P)):
        slot = torch.full_like(a, MASK32)
        for i in range(s, num_hashes, P):
            slot &= flat[base + (((b + i * c) & MASK32) & (rpb - 1))]
        rot = ((g + s) & (P - 1)) * fb
        slot = ((slot >> rot) | (slot << ((32 - rot) & 31))) & MASK32
        acc &= slot
    acc = acc & ((1 << fb) - 1)
    return [acc if owned is None else torch.where(owned, acc, 0)]


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
    local_blocks: int | None = None,
    block_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`reads_query`: int32 [N, C] hit counts.

    Computes in int64 holding uint32 values (PyTorch has no uint32
    shifts or sums on the CPU), a pass of at most ``_PLAIN_READS`` reads
    at a time.
    """
    n, read_len = codes.shape
    nk = read_len - k + 1
    flat = table.reshape(-1).long() & MASK32
    out = torch.zeros((n, num_classes), dtype=torch.int32, device=codes.device)
    for r0 in range(0, n, _PLAIN_READS):
        r = codes[r0 : r0 + _PLAIN_READS].long()
        m = r.shape[0]
        hi, lo, bad = _canonical_windows_plain(r, k, nk)
        ok = ~bad[:, ::step]
        nkk = ok.shape[1]
        words = _and_words_plain(
            hi[:, ::step].reshape(-1), lo[:, ::step].reshape(-1), flat,
            num_blocks=num_blocks, rows_per_block=rows_per_block, class_words=class_words,
            num_hashes=num_hashes, fields_per_word=fields_per_word,
            local_blocks=local_blocks, block_offset=block_offset,
        )
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
    local_blocks: int | None = None,
    block_offset: int = 0,
) -> torch.Tensor:
    """Per-read, per-class hit counts of uniform reads: [N, C].

    ``codes`` is uint8 [N, L] (>3 = invalid base), ``table`` the index's
    row-major table as int32 [num_blocks, rows_per_block * class_words]
    (:func:`table_tensor`).  Windows
    ``0, step, 2*step, ...`` of each read are counted; a window holding
    an invalid base counts nothing.  The result is uint8 when every
    count fits (``ceil((L-k+1)/step) <= 255``), else int32.

    Owned-block mode (``local_blocks`` set): ``table`` holds only the
    ``local_blocks`` blocks from ``block_offset`` on, ``num_blocks`` is
    still the whole stack's count, and a window whose block lies outside
    the table counts nothing.  The counts of shards that tile the stack
    sum to the unsharded counts.
    """
    geom = dict(
        k=k, step=step, num_blocks=num_blocks, rows_per_block=rows_per_block,
        class_words=class_words, num_hashes=num_hashes,
        fields_per_word=fields_per_word, num_classes=num_classes,
        local_blocks=local_blocks, block_offset=block_offset,
    )
    _check_geometry(codes, table, **geom)
    n, read_len = codes.shape
    dtype = count_dtype(read_len, k, step)
    if codes.device.type == "cpu":
        return reads_query_plain(codes, table, **geom).to(dtype)
    if table.device != codes.device:
        raise ValueError("codes and table must share one device")
    codes = codes.contiguous()
    table = _aligned(table)
    wpb, max_reads = _reads_block(read_len, k, step, num_classes)
    out = torch.zeros((n, num_classes), dtype=torch.int32, device=codes.device)
    fn = _kernels.entry("reads_query")
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = fn(
        codes.data_ptr(), table.data_ptr(), out.data_ptr(), n, read_len, k, step,
        num_blocks, rows_per_block, class_words, num_hashes, fields_per_word,
        num_classes, wpb, max_reads, block_offset, local_blocks or 0, stream,
    )
    _kernels.check("reads_query", rc)
    reads_query.launches += 1
    return out.to(dtype)


reads_query.launches = 0


# ---------------------------------------------------------------- K4: records wire


def records_wire_plain(offsets: torch.Tensor, n_pos: int, *, k: int, step: int):
    """Plain PyTorch version of :func:`records_wire`."""
    max_records = offsets.numel() - 1
    pos = torch.arange(n_pos, dtype=torch.int32, device=offsets.device)
    rec = torch.searchsorted(offsets[1:].contiguous(), pos, right=True, out_int32=True)
    rec = rec.clamp_(max=max_records - 1)
    start = offsets[rec.long()]
    rel = pos - start
    nk_r = offsets[rec.long() + 1] - start - (k - 1)
    return rec, (rel < nk_r) & (rel % step == 0)


def _check_offsets(offsets, n_pos, k, step):
    if offsets.dtype != torch.int32 or offsets.dim() != 1 or offsets.numel() < 2:
        raise ValueError("offsets must be a 1-D int32 tensor of at least 2 entries")
    if not 1 <= k <= 32 or step < 1 or n_pos < 0:
        raise ValueError("need 1 <= k <= 32, step >= 1 and n_pos >= 0")


def _records_wire_launch(packed, bad_pos, offsets, n_pos, k, step):
    """K4 on the card: ``(codes or None, rec_ids, valid)``; no codes when
    ``packed`` is None."""
    dev = offsets.device
    offsets = offsets.contiguous()
    codes = None
    ascending = bad_pos is None or _ascending(bad_pos)
    if packed is not None:
        packed, bad_pos = _aligned(packed, "packed"), bad_pos.contiguous()
        codes = torch.empty(n_pos + k - 1, dtype=torch.uint8, device=dev)
    rec_ids = torch.empty(n_pos, dtype=torch.int32, device=dev)
    valid = torch.empty(n_pos, dtype=torch.bool, device=dev)
    m = 0 if bad_pos is None else bad_pos.numel()
    fn = _kernels.entry("records_wire")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(
        None if packed is None else packed.data_ptr(), 0 if packed is None else packed.numel(),
        None if bad_pos is None else bad_pos.data_ptr(), m, int(ascending), offsets.data_ptr(),
        None if codes is None else codes.data_ptr(), rec_ids.data_ptr(), valid.data_ptr(),
        n_pos, offsets.numel() - 1, k, step, stream,
    )
    _kernels.check("records_wire", rc)
    if (codes if codes is not None else rec_ids).numel():
        records_wire.launches += 1 if codes is None or ascending or not m else 2
    return codes, rec_ids, valid


def records_wire(offsets: torch.Tensor, n_pos: int, *, k: int, step: int):
    """Record id and window validity of every position of a flat batch.

    ``offsets`` is int32 [max_records + 1] (record r spans
    ``[offsets[r], offsets[r+1])``; the tail repeats the real base
    count).  Returns ``(rec_ids int32 [n_pos], valid bool [n_pos])``:
    ``rec_ids`` is ``searchsorted(offsets[1:], pos, side="right")``
    clamped to ``max_records - 1``, and a position is valid when a
    whole window of its record starts there on the record's own
    sparse-sampling phase.  On the card this is a launch of K4 without
    codes (:func:`restore_records_wire` is the one the paths use).
    """
    _check_offsets(offsets, n_pos, k, step)
    if offsets.device.type == "cpu":
        return records_wire_plain(offsets, n_pos, k=k, step=step)
    return _records_wire_launch(None, None, offsets, n_pos, k, step)[1:]


def restore_records_wire_plain(packed, bad_pos, offsets, n_pos: int, *, k: int, step: int):
    """Plain PyTorch version of :func:`restore_records_wire`."""
    n_tot = n_pos + k - 1
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=packed.device)
    codes = ((packed[:, None] >> shifts) & 3).reshape(-1)[:n_tot].contiguous()
    pos = bad_pos.long()
    codes[pos[(pos >= 0) & (pos < n_tot)]] = 255
    return (codes, *records_wire_plain(offsets, n_pos, k=k, step=step))


def restore_records_wire(packed, bad_pos, offsets, n_pos: int, *, k: int, step: int):
    """Codes, record ids and validity of a compact records wire
    (:func:`packed_wire_for_batch`) on its device, in one launch of K4.

    ``packed`` is uint8 [>= ceil((n_pos + k - 1) / 4)], ``bad_pos`` int32
    positions set to 255 (entries outside ``[0, n_pos + k - 1)`` are
    dropped), ``offsets`` as in :func:`records_wire`.  Returns ``(codes
    uint8 [n_pos + k - 1], rec_ids int32 [n_pos], valid bool [n_pos])``.
    The patches are set in the same launch when ``bad_pos`` was uploaded
    by :func:`upload_patch_list` and found ascending there, as every list
    :func:`packed_wire_for_batch` builds is; any other list takes a
    second, patch-only launch.
    """
    _check_offsets(offsets, n_pos, k, step)
    if packed.dtype != torch.uint8 or packed.dim() != 1:
        raise ValueError("packed must be a 1-D uint8 tensor")
    if bad_pos.dtype != torch.int32 or bad_pos.dim() != 1:
        raise ValueError("bad_pos must be a 1-D int32 tensor")
    if packed.numel() * 4 < n_pos + k - 1:
        raise ValueError(f"packed holds {packed.numel() * 4} bases, not n_pos + k - 1 = {n_pos + k - 1}")
    if packed.device.type == "cpu":
        return restore_records_wire_plain(packed, bad_pos, offsets, n_pos, k=k, step=step)
    for t in (bad_pos, offsets):
        if t.device != packed.device:
            raise ValueError("packed, bad_pos and offsets must share one device")
    return _records_wire_launch(packed, bad_pos, offsets, n_pos, k, step)


records_wire.launches = 0


# ---------------------------------------------------------------- K3: records query


def _check_records_inputs(codes, rec_ids, valid, k, max_records):
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise ValueError("codes must be a 1-D uint8 tensor")
    if rec_ids.dtype != torch.int32 or rec_ids.dim() != 1:
        raise ValueError("rec_ids must be a 1-D int32 tensor")
    if valid.dtype not in (torch.bool, torch.uint8) or tuple(valid.shape) != tuple(rec_ids.shape):
        raise ValueError("valid must be a bool or uint8 tensor shaped like rec_ids")
    n_pos = rec_ids.numel()
    if codes.numel() < n_pos + k - 1:
        raise ValueError(f"codes must hold n_pos + k - 1 = {n_pos + k - 1} bases")
    if max_records < 1:
        raise ValueError("max_records must be >= 1")


def _block_range(num_classes: int, max_records: int, record_len: int | None, k: int):
    """``(positions_per_block, counter_rows)`` of a records kernel's
    thread blocks.  A block's positions span at most
    ``(ppb-1)//record_len + 2`` records, whose counters should fit its
    shared-memory rows; a block whose span does not fit counts in global
    memory instead, so the counts do not depend on the choice."""
    shortest = max(k + 1, record_len or 0)
    rows = min(_counter_rows(num_classes), max_records)
    ppb = _WINDOWS_PER_BLOCK
    if rows >= 3:
        ppb = min(ppb, (rows - 2) * shortest + 1)
    return ppb, rows


def records_query_plain(
    codes: torch.Tensor,
    rec_ids: torch.Tensor,
    valid: torch.Tensor,
    table: torch.Tensor,
    *,
    max_records: int,
    k: int,
    num_blocks: int,
    rows_per_block: int,
    class_words: int,
    num_hashes: int,
    fields_per_word: int,
    num_classes: int,
    local_blocks: int | None = None,
    block_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`records_query`, a pass of at most
    ``_PLAIN_POSITIONS`` positions at a time."""
    n_pos = rec_ids.numel()
    flat = table.reshape(-1).long() & MASK32
    out = torch.zeros((max_records, num_classes), dtype=torch.int32, device=codes.device)
    probe = dict(
        num_blocks=num_blocks, rows_per_block=rows_per_block, class_words=class_words,
        num_hashes=num_hashes, fields_per_word=fields_per_word,
        local_blocks=local_blocks, block_offset=block_offset,
    )
    for p0 in range(0, n_pos, _PLAIN_POSITIONS):
        p1 = min(n_pos, p0 + _PLAIN_POSITIONS)
        rec = rec_ids[p0:p1].long()
        hi, lo, bad = _canonical_windows_plain(codes[None, p0 : p1 + k - 1].long(), k, p1 - p0)
        keep = valid[p0:p1].bool() & (rec >= 0) & (rec < max_records) & ~bad[0]
        pick = keep.nonzero().squeeze(1)
        if not pick.numel():
            continue
        words = _and_words_plain(hi[0, pick], lo[0, pick], flat, **probe)
        rec = rec[pick]
        for w, word in enumerate(words):
            nb = min(32, num_classes - 32 * w)
            bits = (word[:, None] >> torch.arange(nb, device=word.device)) & 1
            out[:, 32 * w : 32 * w + nb].index_add_(0, rec, bits.int())
    return out


def records_query(
    codes: torch.Tensor,
    rec_ids: torch.Tensor,
    valid: torch.Tensor,
    table: torch.Tensor,
    *,
    max_records: int,
    k: int,
    num_blocks: int,
    rows_per_block: int,
    class_words: int,
    num_hashes: int,
    fields_per_word: int,
    num_classes: int,
    min_record_len: int | None = None,
    local_blocks: int | None = None,
    block_offset: int = 0,
) -> torch.Tensor:
    """Per-record, per-class hit counts of a flat batch: int32 [max_records, C].

    ``codes`` is uint8 [n_pos + k - 1] (>3 = invalid base), ``rec_ids``
    int32 [n_pos], ``valid`` bool or uint8 [n_pos], ``table`` the
    index's row-major table as int32 (:func:`table_tensor`).  The window
    starting at each valid position counts for its record unless it holds
    an invalid base; a record id outside ``[0, max_records)`` counts
    nothing.
    ``min_record_len``, the batch's shortest record, sizes the kernel's
    thread blocks so that most count in shared memory; the counts do
    not depend on it.  ``local_blocks`` and ``block_offset`` select the
    owned-block mode of :func:`reads_query`.
    """
    _check_records_inputs(codes, rec_ids, valid, k, max_records)
    geom = dict(
        k=k, num_blocks=num_blocks, rows_per_block=rows_per_block, class_words=class_words,
        num_hashes=num_hashes, fields_per_word=fields_per_word, num_classes=num_classes,
        local_blocks=local_blocks, block_offset=block_offset,
    )
    _check_table_geometry(table, **geom)
    if codes.device.type == "cpu":
        return records_query_plain(codes, rec_ids, valid, table, max_records=max_records, **geom)
    for t in (rec_ids, valid, table):
        if t.device != codes.device:
            raise ValueError("codes, rec_ids, valid and table must share one device")
    codes, rec_ids, table = codes.contiguous(), rec_ids.contiguous(), _aligned(table)
    valid = valid.contiguous().view(torch.uint8)
    ppb, rows = _block_range(num_classes, max_records, min_record_len, k)
    n_pos = rec_ids.numel()
    out = torch.zeros((max_records, num_classes), dtype=torch.int32, device=codes.device)
    fn = _kernels.entry("records_query")
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = fn(
        codes.data_ptr(), rec_ids.data_ptr(), valid.data_ptr(), table.data_ptr(),
        out.data_ptr(), n_pos, k, num_blocks, rows_per_block, class_words, num_hashes,
        fields_per_word, num_classes, max_records, ppb, rows, block_offset,
        local_blocks or 0, stream,
    )
    _kernels.check("records_query", rc)
    records_query.launches += 1
    return out


records_query.launches = 0


# ---------------------------------------------------------------- K5: multi-index query

# tables per launch of K5 and K6: their descriptors travel in the
# kernels' parameters (MLST schemes have 7 or 8 loci)
MAX_TABLES = 16
_GEOM_KEYS = ("num_blocks", "rows_per_block", "class_words", "num_hashes",
              "fields_per_word", "num_classes")


def _check_tables(tables, geoms):
    if len(tables) != len(geoms):
        raise ValueError("tables and geoms must have equal length")
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(
            f"a multi-index query takes 1 to {MAX_TABLES} tables, not {len(tables)}"
        )
    if len({g["k"] for g in geoms}) != 1:
        raise ValueError("all tables of a multi-index query must share k")
    for table, g in zip(tables, geoms):
        _check_table_geometry(table, **g)


def multi_records_query_plain(tables, geoms, codes, rec_ids, valid, *, max_records: int):
    """Plain PyTorch version of :func:`multi_records_query`: the plain
    records query once per table."""
    return [
        records_query_plain(codes, rec_ids, valid, table, max_records=max_records, **g)
        for table, g in zip(tables, geoms)
    ]


def _probe_kind(g: dict) -> int:
    """The probe path of a geometry, numbered as ``probe_kind`` of
    csrc/kmer_probe.cuh: field-packed words, or probe rows read as 1-,
    2- or 4-word vectors."""
    if g["fields_per_word"] > 1:
        return 0
    cw = g["class_words"]
    return 3 if cw % 4 == 0 else 2 if cw % 2 == 0 else 1


def multi_records_query(
    tables, geoms, codes, rec_ids, valid, *, max_records: int, min_record_len: int | None = None
):
    """Per-record, per-class hit counts of one flat batch against several
    index tables: a list of int32 [max_records, C_l], one per table.

    ``tables`` are row-major tables as int32 (:func:`table_tensor`),
    ``geoms`` their geometries (:meth:`DeviceQueryEngine.geometry`); all
    share ``k``, everything else is each table's own.  ``codes``,
    ``rec_ids`` and ``valid`` are those of :func:`records_query`, and
    table l's counts equal ``records_query`` on it.  At most
    :data:`MAX_TABLES` tables go into one call; the kernel is launched
    once for each probe path among them (:func:`_probe_kind`), so each
    launch runs the build of its own path.  ``min_record_len``, the
    length of the batch's typical record, sizes each table's thread
    blocks; the counts do not depend on it.  The returned tensors are
    views of one buffer.
    """
    tables, geoms = list(tables), list(geoms)
    _check_tables(tables, geoms)
    k = geoms[0]["k"]
    _check_records_inputs(codes, rec_ids, valid, k, max_records)
    if codes.device.type == "cpu":
        return multi_records_query_plain(
            tables, geoms, codes, rec_ids, valid, max_records=max_records
        )
    for t in (rec_ids, valid, *tables):
        if t.device != codes.device:
            raise ValueError("codes, rec_ids, valid and every table must share one device")
    codes, rec_ids = codes.contiguous(), rec_ids.contiguous()
    valid = valid.contiguous().view(torch.uint8)
    tables = [_aligned(t) for t in tables]
    sizes = [max_records * g["num_classes"] for g in geoms]
    flat = torch.zeros(sum(sizes), dtype=torch.int32, device=codes.device)
    outs = [
        part.view(max_records, g["num_classes"]) for part, g in zip(flat.split(sizes), geoms)
    ]
    fn = _kernels.entry("multi_records_query")
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    for kind in sorted({_probe_kind(g) for g in geoms}):
        group = [l for l, g in enumerate(geoms) if _probe_kind(g) == kind]
        rows = []
        for l in group:
            ppb, counter_rows = _block_range(geoms[l]["num_classes"], max_records, min_record_len, k)
            rows += [geoms[l][key] for key in _GEOM_KEYS] + [ppb, counter_rows]
        n = len(group)
        rc = fn(
            codes.data_ptr(), rec_ids.data_ptr(), valid.data_ptr(), rec_ids.numel(), k,
            max_records, n, (ctypes.c_void_p * n)(*(tables[l].data_ptr() for l in group)),
            (ctypes.c_void_p * n)(*(outs[l].data_ptr() for l in group)),
            (ctypes.c_int64 * len(rows))(*rows), stream,
        )
        _kernels.check("multi_records_query", rc)
        multi_records_query.launches += 1
    return outs


multi_records_query.launches = 0


# ---------------------------------------------------------------- K6: reduction

REDUCE_MODES = ("thresholded_totals", "first_record", "thresholded_segment_totals")


def reduce_record_counts_plain(counts, mode, threshold=0, seg_ids=None, num_segments=None):
    """Plain PyTorch version of :func:`reduce_record_counts`."""
    outs = []
    for h in counts:
        if mode == "first_record":
            outs.append(h[0].clone())
            continue
        hz = torch.where(h > threshold, h, 0)
        if mode == "thresholded_totals":
            outs.append(hz.sum(dim=0, dtype=torch.int32))
            continue
        seg = seg_ids.long()
        keep = (seg >= 0) & (seg < num_segments)
        out = torch.zeros((num_segments, h.shape[1]), dtype=torch.int32, device=h.device)
        outs.append(out.index_add_(0, seg[keep], hz[keep]))
    return outs


def reduce_record_counts(counts, mode, threshold=0, seg_ids=None, num_segments=None):
    """Reduce per-record hit counts over the records, on the device.

    ``counts`` is a sequence of int32 [max_records, C_l] tensors (the
    outputs of :func:`multi_records_query`), at most :data:`MAX_TABLES`;
    one launch reduces all of them.  ``mode`` is

    - ``"thresholded_totals"``: ``sum_r where(h > threshold, h, 0)``,
      int32 [C_l] (``>`` is strict; ``threshold=-1`` keeps every count);
    - ``"first_record"``: row 0, int32 [C_l];
    - ``"thresholded_segment_totals"``: the thresholded counts summed
      per segment, int32 [num_segments, C_l]; ``seg_ids`` is int32
      [max_records], record slot -> segment, and an entry outside
      ``[0, num_segments)`` adds nothing.
    """
    counts = list(counts)
    if mode not in REDUCE_MODES:
        raise ValueError(f"unknown reduce mode {mode!r}: expected one of {REDUCE_MODES}")
    if not 1 <= len(counts) <= MAX_TABLES:
        raise ValueError(f"a reduction takes 1 to {MAX_TABLES} count tensors, not {len(counts)}")
    max_records = counts[0].shape[0]
    for h in counts:
        if h.dtype != torch.int32 or h.dim() != 2 or h.shape[0] != max_records or not h.numel():
            raise ValueError("counts must be non-empty 2-D int32 tensors of equal row count")
        if h.device != counts[0].device:
            raise ValueError("all count tensors must share one device")
    segmented = mode == "thresholded_segment_totals"
    if segmented:
        if not num_segments or num_segments < 1:
            raise ValueError("thresholded_segment_totals requires num_segments >= 1")
        if seg_ids is None or seg_ids.dtype != torch.int32 or tuple(seg_ids.shape) != (max_records,):
            raise ValueError("seg_ids must be an int32 tensor of max_records entries")
        if seg_ids.device != counts[0].device:
            raise ValueError("seg_ids and the counts must share one device")
    device = counts[0].device
    if device.type == "cpu":
        return reduce_record_counts_plain(counts, mode, threshold, seg_ids, num_segments)
    counts = [h.contiguous() for h in counts]
    out_rows = num_segments if segmented else 1
    sizes = [out_rows * h.shape[1] for h in counts]
    flat = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
    outs = [
        part.view(out_rows, h.shape[1]) if segmented else part
        for part, h in zip(flat.split(sizes), counts)
    ]
    seg = seg_ids.contiguous() if segmented else None
    n = len(counts)
    fn = _kernels.entry("segment_reduce")
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(
        (ctypes.c_void_p * n)(*(h.data_ptr() for h in counts)),
        (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs)),
        (ctypes.c_int * n)(*(h.shape[1] for h in counts)), n,
        seg.data_ptr() if segmented else None, max_records,
        REDUCE_MODES.index(mode), threshold, out_rows, min(_REDUCE_ROWS, max_records), stream,
    )
    _kernels.check("segment_reduce", rc)
    reduce_record_counts.launches += 1
    return outs


reduce_record_counts.launches = 0


def make_multi_packed_query(
    geoms,
    step: int,
    n_pos: int,
    reduce_mode: str | None = None,
    threshold: int = 0,
    num_segments: int | None = None,
    min_record_len: int | None = None,
):
    """The query of SEVERAL indices over one compact records wire, with
    the reduction over the records on the device: the counterpart of the
    JAX package's ``make_multi_packed_query``.

    Returns ``fn(tables, packed, bad_pos, offsets, seg_ids=None)`` giving
    a tuple with one tensor per table: int32
    [max_records, C_l] when ``reduce_mode`` is None, else what
    :func:`reduce_record_counts` gives for that mode.  ``geoms`` are the
    tables' geometries, ``n_pos`` the batch's position count
    (``max_records`` is read off ``offsets``).  One call on the wire of
    :func:`upload_records_wire` launches K4 once, K5 once for each probe path among the tables and K6
    once.
    """
    geoms = list(geoms)
    if reduce_mode is not None and reduce_mode not in REDUCE_MODES:
        raise ValueError(f"unknown reduce mode {reduce_mode!r}: expected one of {REDUCE_MODES}")
    if reduce_mode == "thresholded_segment_totals" and (not num_segments or num_segments < 1):
        raise ValueError("thresholded_segment_totals requires num_segments >= 1")

    def fn(tables, packed, bad_pos, offsets, seg_ids=None):
        codes, rec_ids, valid = restore_records_wire(
            packed, bad_pos, offsets, n_pos, k=geoms[0]["k"], step=step
        )
        counts = multi_records_query(
            tables, geoms, codes, rec_ids, valid,
            max_records=offsets.numel() - 1, min_record_len=min_record_len,
        )
        if reduce_mode is None:
            return tuple(counts)
        return tuple(reduce_record_counts(counts, reduce_mode, threshold, seg_ids, num_segments))

    return fn


# ---------------------------------------------------------------- engine


class DeviceQueryEngine:
    """Holds an index table resident on the device and queries reads and
    record batches."""

    def __init__(self, index: BlockedBitSlicedIndex, device=None, chunk: int = DEFAULT_CHUNK):
        self.index = index
        self.device = resolve_device(device)
        # the JAX engine's chunk rule (it shrinks the chunk for wide class
        # counts), so both pad a batch alike
        cw = index.class_words
        self.chunk = min(chunk, max(8192, _next_pow2((1 << 19) // cw + 1) // 2))
        self.table = table_tensor(index, self.device)

    def geometry(self) -> dict:
        """The index geometry as :func:`reads_query` and
        :func:`records_query` take it."""
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
        with profiling.phase("query.pack"):
            wire = pack_reads_wire(reads, self.index.k, n_pad)
        return wire_to_device(wire, self.device)

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

    def upload_records_wire(self, batch: PreparedBatch, max_records: int):
        """The compact wire of :meth:`count_hits` on the device
        (:func:`upload_records_wire`), cached on the batch."""
        return upload_records_wire(batch, max_records, self.device)

    def count_hits(self, batch: PreparedBatch, block: bool = True, wire: str = "auto"):
        """Hit counts of a prepared batch: int64 [batch.num_records, num_classes].

        With ``block=False`` the padded int32 [batch.max_records, C]
        device tensor is returned without synchronizing.
        ``wire="packed"`` ships 2-bit codes, a patch list and the record
        offsets, and derives record ids and validity on the device;
        ``wire="raw"`` ships codes, record ids and validity as they are.
        ``"auto"`` picks packed when the batch has offsets
        (:func:`prepare_batch`) and raw otherwise
        (:func:`prepare_fixed_batch`).
        """
        idx = self.index
        if wire not in ("auto", "packed", "raw"):
            raise ValueError(
                f"unknown wire format {wire!r}: expected 'auto', 'packed' or 'raw'"
            )
        if wire == "packed" and batch.offsets is None:
            raise ValueError(
                "wire='packed' requires a batch with record offsets "
                "(prepare_batch); this batch has none"
            )
        if wire == "auto":
            wire = "packed" if batch.offsets is not None else "raw"
        if batch.num_records == 0:
            return np.zeros((0, idx.num_classes), dtype=np.int64)
        if wire == "packed":
            # the host packing and the upload, once a batch, stay out of
            # "query.dispatch": restore_batch finds them cached
            self.upload_records_wire(batch, batch.max_records)
        with profiling.phase("query.dispatch"):
            if wire == "packed":
                codes, rec_ids, valid = restore_batch(batch, self.device)
            else:
                codes, rec_ids, valid = (
                    torch.from_numpy(a).to(self.device)
                    for a in (batch.codes, batch.rec_ids, batch.valid)
                )
            out = records_query(
                codes, rec_ids, valid, self.table, max_records=batch.max_records,
                min_record_len=batch.min_record_len, **self.geometry(),
            )
        if not block:
            return out
        with profiling.phase("query.sync"):
            return out[: batch.num_records].cpu().numpy().astype(np.int64)

    def count_hits_records(self, records, step: int = 1, block: bool = True):
        """``(name, codes)`` records -> int64 [n_records, C] hits."""
        batch = prepare_batch(records, self.index.k, step=step, chunk=self.chunk)
        return self.count_hits(batch, block=block)
