"""The sum of randomly gathered table rows: kernel K9.

:func:`row_gather` (``csrc/row_gather.cu``) is the counterpart of the
fused XLA program that the JAX package's measurement tools time,
``jnp.sum(jnp.take(t, i, axis=0), dtype=jnp.uint32)``
(``tools/recalibrate_constants.py:50``, ``microbench_gather.py``,
``microbench_sorted_gather.py``, ``microbench_split.py``): it reads each
gathered row once and writes no gathered copy, as XLA's fusion does.
The port's tools (:mod:`xspect2_tpu_torch.tools`) time it to measure the
card's gather rate against row width, table size and index order.

:func:`row_gather_plain` is the plain PyTorch version of the same
function; the wrapper uses it only for tensors on the CPU, and counts
its kernel launches in ``row_gather.launches``.  :func:`grid_stride`
gives the step at which the kernel's grid walks the indices;
:func:`in_order_floor_bytes` is the least HBM traffic of a kernel that
keeps the gather's order on uniformly random indices, the bound that K9
is held to beside the distinct-row bound.
"""

import torch

from xspect2_tpu_torch.core.hashing import MASK32
from xspect2_tpu_torch.ops import _kernels

MODES = {"total": 0, "per_row": 1, "window": 2}
# the H100's L2 (NVIDIA's data sheet)
L2_BYTES = 50e6
# the kernel's launch: blocks of THREADS_A_BLOCK threads, at most
# BLOCKS_AN_SM of them an SM (kThreads and kBlocksPerSm in
# csrc/row_gather.cu, which the tests read back)
THREADS_A_BLOCK = 256
BLOCKS_AN_SM = 8


def _check(table, idx, mode, window):
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] < 4 or table.shape[1] % 4:
        raise ValueError("table must be an int32 tensor [rows, W] (uint32 bits) with W a multiple of 4")
    if table.shape[0] == 0:
        raise ValueError("table has no rows")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("idx must be a 1-D int32 tensor")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: expected one of {sorted(MODES)}")
    if (mode == "window") != (window is not None):
        raise ValueError("window=(offset, bound) is given with mode='window' and only then")
    if window is not None:
        offset, bound = window
        if not 0 < bound <= table.shape[0] or offset < 0:
            raise ValueError(
                f"window needs offset >= 0 and 0 < bound <= rows ({table.shape[0]}), not {window}"
            )


def row_gather_plain(
    table: torch.Tensor, idx: torch.Tensor, mode: str = "total", window: tuple[int, int] | None = None
) -> torch.Tensor:
    """Plain PyTorch version of :func:`row_gather`.

    Computes in int64 holding uint32 values masked with ``& 0xFFFFFFFF``
    (PyTorch has no uint32 ``+`` on the CPU); a row's sum fits int64
    for any width, so the rows are summed first and masked, then summed.
    """
    _check(table, idx, mode, window)
    i = idx.long()
    inside = None
    if window is None:
        i = i.clamp(0, table.shape[0] - 1)
    else:
        offset, bound = window
        i = i - offset
        inside = (i >= 0) & (i < bound)
        i = i.clamp(0, bound - 1)
    sums = (table[i].long() & MASK32).sum(dim=1) & MASK32
    if inside is not None:
        sums = torch.where(inside, sums, 0)
    if mode == "per_row":
        return sums.to(torch.int32)
    return (sums.sum() & MASK32).to(torch.int32)


def row_gather(
    table: torch.Tensor, idx: torch.Tensor, mode: str = "total", window: tuple[int, int] | None = None
) -> torch.Tensor:
    """Sums of the uint32 words of the rows ``idx`` of ``table``, mod 2**32.

    ``table`` is int32 [rows, W] holding uint32 bits, ``W`` a multiple
    of 4; ``idx`` int32 [n].  ``mode``:

    - ``"total"``: one sum over every word of every gathered row, a 0-d
      int32 tensor (uint32 bits);
    - ``"per_row"``: each gathered row's sum, int32 [n] (uint32 bits);
    - ``"window"`` with ``window=(offset, bound)``: as ``"total"``, where
      ``table``'s rows ``0 .. bound-1`` are the rows ``offset ..
      offset+bound-1`` of the index space; an index outside them adds 0.

    Outside the window mode an index outside ``[0, rows)`` reads the
    nearest row.
    """
    _check(table, idx, mode, window)
    if table.device.type == "cpu":
        return row_gather_plain(table, idx, mode, window)
    if idx.device != table.device:
        raise ValueError("table and idx must share one device")
    table, idx = table.contiguous(), idx.contiguous()
    if table.data_ptr() % 16:  # the kernel loads 16 bytes a lane
        raise ValueError("the table must start at a 16-byte aligned address")
    n = idx.shape[0]
    if mode == "per_row":
        out = torch.empty(n, dtype=torch.int32, device=table.device)
    else:
        out = torch.zeros(1, dtype=torch.int32, device=table.device)
    if n:
        offset, bound = window if window is not None else (0, 0)
        fn = _kernels.entry("row_gather")
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, table.shape[0], table.shape[1],
            MODES[mode], offset, bound, stream,
        )
        _kernels.check("row_gather", rc)
        row_gather.launches += 1
    return out if mode == "per_row" else out[0]


row_gather.launches = 0


def lanes_a_row(row_words: int) -> int:
    """The lanes of a warp that share one row: 32 for rows of 512 B and
    more, else the largest power of two of 16 B vectors a row holds."""
    lanes = 1
    while lanes < 32 and 2 * lanes <= row_words // 4:
        lanes *= 2
    return lanes


def grid_stride(row_words: int, sms: int) -> int:
    """The indices that the kernel's full grid takes a step of its walk
    on a card of ``sms`` SMs, at rows of ``row_words`` words: the step at
    which each warp comes back for its next indices."""
    return sms * BLOCKS_AN_SM * THREADS_A_BLOCK // lanes_a_row(row_words)


def in_order_floor_bytes(n: int, row_bytes: int, table_bytes: float, distinct_rows: int,
                         l2_bytes: float = L2_BYTES) -> float:
    """The least device-memory traffic of a kernel that loads every one of
    ``n`` uniformly random, independent indices' rows, in the given order,
    from a table of ``table_bytes`` through an L2 of ``l2_bytes``: each
    distinct row at least once, and at least the share of the ``n`` loads
    that the L2 cannot hold, ``n x row_bytes x (1 - L2 / table)``, since
    a random row is in the L2 at most ``L2 / table`` of the time; then the
    indices (4n B) and the 4 B sum.  The distinct-row bound is the first
    term alone, and it is the only floor for sorted or repeated indices,
    which hit the L2 more often."""
    rows = max(distinct_rows * row_bytes, n * row_bytes * (1 - l2_bytes / table_bytes))
    return rows + 4 * n + 4


def as_uint32(x: torch.Tensor) -> int:
    """A 0-d int32 result of :func:`row_gather` as the uint32 it holds."""
    return int(x) & MASK32
