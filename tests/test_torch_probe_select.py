"""The probe-select function (kernel K8) and its microbenchmark pipeline.

The JAX package's ``sel_kernel`` (``tools/microbench_pallas.py``) is a
Pallas kernel that lowers only for a TPU (it rotates lanes with
``pltpu.roll``), so it cannot run here, not even in interpret mode.  The
reference below is its arithmetic written out in numpy, line for line:
expand the row mask to the 128 lanes (lane ``l`` is row ``l % rpb``),
force the unselected lanes to all-ones, AND each class word's segment of
``rpb`` lanes.  The pipeline around it (hash prologue, block gather, row
mask pack, per-class counts) is held against the shipped read query's
plain version on the same reads, as the JAX tool holds ``pallas == xla``.
"""

import numpy as np
import pytest
import torch

from xspect2_tpu.core import hashing as jax_hashing
from xspect2_tpu_torch.ops import query
from xspect2_tpu_torch.ops.probe_select import probe_select, probe_select_plain
from xspect2_tpu_torch.tools import microbench_probe


def sel_kernel_numpy(selbits: np.ndarray, blocks: np.ndarray, rpb: int, cw: int) -> np.ndarray:
    """``sel_kernel``'s arithmetic over uint32 arrays [T, W], [T, 128] -> [T, cw]."""
    sel_words = max(1, rpb // 32)
    rep = np.concatenate([np.repeat(selbits[:, w : w + 1], 32, axis=1) for w in range(sel_words)], axis=1)
    rep = np.tile(rep[:, :rpb], (1, cw))  # [T, 128]
    lane = np.arange(128, dtype=np.uint32)
    selbit = (rep >> ((lane % rpb) % 32)) & np.uint32(1)
    x = np.where(selbit == 1, blocks, np.uint32(0xFFFFFFFF))
    return np.bitwise_and.reduce(x.reshape(-1, cw, rpb), axis=2)


def _case(rng, num_kmers, cw):
    rpb = 128 // cw
    blocks = rng.integers(0, 2**32, size=(num_kmers, 128), dtype=np.uint64).astype(np.uint32)
    sel = rng.integers(0, 2**32, size=(num_kmers, max(1, rpb // 32)), dtype=np.uint64)
    sel &= rng.integers(0, 2**32, size=sel.shape, dtype=np.uint64)
    if rpb < 32:
        sel &= (1 << rpb) - 1
    sel[0] = 0
    return sel.astype(np.uint32), blocks, rpb


@pytest.mark.parametrize("cw", [1, 2, 4, 8, 16])
def test_probe_select_plain_equals_the_pallas_kernels_arithmetic(cw):
    rng = np.random.default_rng(cw)
    sel, blocks, rpb = _case(rng, 301, cw)
    args = (torch.from_numpy(sel.view(np.int32)), torch.from_numpy(blocks.view(np.int32)))
    got = probe_select_plain(*args, rows_per_block=rpb, class_words=cw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (301, cw)
    want = sel_kernel_numpy(sel, blocks, rpb, cw)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (want[0] == 0xFFFFFFFF).all()  # no row selected
    # on the CPU the wrapper is its plain version, and launches nothing
    before = probe_select.launches
    assert torch.equal(probe_select(*args, rows_per_block=rpb, class_words=cw), got)
    assert probe_select.launches == before


def test_probe_select_refuses_bad_shapes():
    sel, blocks, _ = _case(np.random.default_rng(0), 5, 2)
    s, b = torch.from_numpy(sel.view(np.int32)), torch.from_numpy(blocks.view(np.int32))
    for kwargs in (dict(rows_per_block=32, class_words=2), dict(rows_per_block=4, class_words=32),
                   dict(rows_per_block=48, class_words=2)):
        with pytest.raises(ValueError, match="rows_per_block"):
            probe_select(s, b, **kwargs)
    with pytest.raises(ValueError, match="blocks"):
        probe_select(s, b[:, :64], rows_per_block=64, class_words=2)
    with pytest.raises(ValueError, match="selbits"):
        probe_select(s[:, :1], b, rows_per_block=64, class_words=2)
    with pytest.raises(ValueError, match="blocks"):
        probe_select(s, b.long(), rows_per_block=64, class_words=2)


@pytest.mark.parametrize("classes,num_hashes", [(8, 7), (40, 3), (100, 2), (512, 4)])
def test_microbench_pipeline_equals_the_read_query(classes, num_hashes, capsys):
    res = microbench_probe.run(table_mb=0.2, classes=classes, num_hashes=num_hashes, reads=24,
                               reads_per_chunk=8, iters=1, device="cpu")
    assert res["equal"] and res["kmers_per_chunk"] == 8 * 130
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "probe_select == reads_query: True"
    assert lines[1].startswith("reads_query ") and lines[2].startswith("probe_select") and "reads/s" in lines[2]


def test_microbench_prologue_and_row_mask_equal_the_jax_tools():
    """The tool's hash prologue gives the JAX package's block and row ids
    (``hashing.block_and_rows``), and its row mask has exactly those bits."""
    from xspect2_tpu_torch.core.hashing import block_words_fieldbase_torch

    rng = np.random.default_rng(2)
    reads = rng.integers(0, 4, size=(6, 150), dtype=np.uint8)
    hi, lo, _ = query._canonical_windows_plain(torch.from_numpy(reads).long(), 21, 130)
    block, rows, _ = block_words_fieldbase_torch(hi.reshape(-1), lo.reshape(-1), 977, 64, 7)
    j_block, j_rows = jax_hashing.block_and_rows(
        hi.reshape(-1).numpy().astype(np.uint32), lo.reshape(-1).numpy().astype(np.uint32), 977, 64, 7)
    np.testing.assert_array_equal(block.numpy(), np.asarray(j_block))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
    mask = microbench_probe.pack_row_mask(rows, 64).numpy().view(np.uint32)
    want = np.zeros((len(rows), 2), dtype=np.uint32)
    for h in range(7):
        r = rows[:, h].numpy()
        np.bitwise_or.at(want, (np.arange(len(r)), r >> 5), np.uint32(1) << (r & 31).astype(np.uint32))
    np.testing.assert_array_equal(mask, want)


def test_microbench_main_takes_the_jax_tools_arguments(capsys):
    rc = microbench_probe.main([
        "--table-mb", "0.1", "--classes", "8", "--num-hashes", "2", "--reads", "16",
        "--reads-per-chunk", "8", "--iters", "1", "--device", "cpu",
    ])
    assert rc == 0 and "probe_select == reads_query: True" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        microbench_probe.main(["--tile", "2080"])  # a TPU tile size has no meaning here
    with pytest.raises(ValueError, match="multiple"):
        microbench_probe.run(reads=10, reads_per_chunk=8, device="cpu")
