"""K9's in-order floor and its grid stride, on the CPU.

``in_order_floor_bytes`` is the least device-memory traffic of a gather
that keeps every index's row load in order on uniformly random indices
(PERF.md's bound column keeps the distinct-row bound beside it);
``grid_stride`` is the step at which the kernel's launch walks the
indices, which the card tests and the smoke probe around.
"""

import re
from pathlib import Path

import pytest

from xspect2_tpu_torch.ops import row_gather as rg

HBM_BYTES_PER_S = 3.35e12
SOURCE = Path(rg.__file__).resolve().parent.parent / "csrc" / "row_gather.cu"


def test_in_order_floor_at_the_timed_shape_and_either_side_of_the_l2():
    """2**21 indices of 512 B rows, 388,797 of them distinct, on a 200 MB
    table: a quarter of the loads may hit the 50 MB L2, so 0.75 of the
    gathered bytes plus the indices and the 4 B sum, 0.2429 ms at 3.35
    TB/s.  A table the L2 holds costs its distinct rows once; an 800 MB
    table 15/16 of every gathered row."""
    n = 1 << 21
    floor = rg.in_order_floor_bytes(n, 512, 200e6, 388_797)
    assert floor == 813_694_980
    assert round(floor / HBM_BYTES_PER_S * 1e3, 4) == 0.2429
    assert rg.in_order_floor_bytes(n, 512, 40e6, 78_000) == 78_000 * 512 + 4 * n + 4
    assert rg.in_order_floor_bytes(n, 512, 800e6, 1_000_000) == n * 512 * 15 / 16 + 4 * n + 4
    # an L2 of another size moves the share it may serve
    assert rg.in_order_floor_bytes(n, 512, 200e6, 1, l2_bytes=100e6) == n * 512 * 0.5 + 4 * n + 4


def test_launch_constants_are_the_kernels():
    """The Python launch constants are csrc/row_gather.cu's."""
    text = SOURCE.read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", text).group(1))
    blocks = int(re.search(r"constexpr int kBlocksPerSm = (\d+);", text).group(1))
    assert (rg.THREADS_A_BLOCK, rg.BLOCKS_AN_SM) == (threads, blocks)
    assert "while (group_log2 < 5 && (2 << group_log2) <= row_vecs) ++group_log2;" in text


@pytest.mark.parametrize(
    "row_words, lanes, stride",
    [(4, 1, 270_336), (8, 2, 135_168), (12, 2, 135_168), (40, 8, 33_792), (64, 16, 16_896),
     (128, 32, 8_448), (1024, 32, 8_448)],
)
def test_grid_stride_at_each_row_width(row_words, lanes, stride):
    """Lanes a row: the largest power of two of 16 B vectors a row holds,
    at most 32 (the kernel's group_log2 loop); the grid stride on 132 SMs
    (an H100 SXM): 8 blocks of 256 threads an SM over the lanes a row."""
    assert rg.lanes_a_row(row_words) == lanes
    assert rg.grid_stride(row_words, 132) == stride
