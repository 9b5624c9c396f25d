"""K9, the fused row gather, and the gather microbenchmarks of the port.

K9's plain version (the wrapper on CPU tensors) goes against the fused
XLA program that the JAX package's tools time,
``jnp.sum(jnp.take(t, i, axis=0), dtype=jnp.uint32)``, on numpy-seeded
tables, exactly: the total, the per-row payload of
``tools/microbench_sorted_gather.py``'s pipeline, and the clamped,
masked window of ``tools/microbench_split.py``'s ``make_split``, written
out here in jnp.  Each tool of ``xspect2_tpu_torch/tools`` runs on
``device="cpu"`` at a tiny size against the JAX tool's columns and
checksums.
"""

import importlib.util
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xspect2_tpu_torch.ops import _kernels
from xspect2_tpu_torch.ops import row_gather as rg
from xspect2_tpu_torch.tools import (
    microbench_blockshard,
    microbench_fields,
    microbench_gather,
    microbench_sorted_gather,
    microbench_split,
    recalibrate_constants,
)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Every tensor here is tiny: one intra-op thread keeps the plain
    versions' many small ops from waiting on other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _table(rng, rows, width):
    return rng.integers(0, 2**32, size=(rows, width), dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@jax.jit
def _jax_total(t, i):
    return jnp.sum(jnp.take(t, i, axis=0), dtype=jnp.uint32)


@jax.jit
def _jax_per_row(t, i):
    return jnp.sum(jnp.take(t, i, axis=0), axis=1, dtype=jnp.uint32)


def _jax_window(t, i, offset, bound):
    """``make_split``'s arithmetic for one window (tools/microbench_split.py:424-431)."""
    sub = jax.lax.slice_in_dim(t, offset, offset + bound, axis=0)
    li = i - offset
    inside = (li >= 0) & (li < bound)
    li = jnp.clip(li, 0, bound - 1)
    g = jnp.take(sub, li, axis=0)
    g = jnp.where(inside[:, None], g, jnp.uint32(0))
    return jnp.sum(g, dtype=jnp.uint32)


@pytest.mark.parametrize("width", [32, 128, 1024])
def test_plain_row_gather_is_the_fused_jax_take_and_sum(width):
    """Total and per-row sums, indices at both ends and repeated; the sums
    wrap mod 2**32 (random words, and a table of all-ones words)."""
    rng = np.random.default_rng(width)
    rows = 97
    for table in (_table(rng, rows, width), np.full((rows, width), 0xFFFFFFFF, dtype=np.uint32)):
        idx = rng.integers(0, rows, size=300, dtype=np.int32)
        idx[:6] = [0, rows - 1, 0, rows - 1, rows - 1, 0]
        want_total = int(_jax_total(table, idx))
        want_rows = np.asarray(_jax_per_row(table, idx))
        got_total = rg.row_gather(_t(table), torch.from_numpy(idx))
        got_rows = rg.row_gather(_t(table), torch.from_numpy(idx), mode="per_row")
        assert got_total.dtype == got_rows.dtype == torch.int32 and got_total.dim() == 0
        assert rg.as_uint32(got_total) == want_total
        np.testing.assert_array_equal(got_rows.numpy().view(np.uint32), want_rows)
        # the per-row sums are the pipeline's payload, and their sum the total
        assert int(got_rows.long().sum()) & 0xFFFFFFFF == want_total
    assert int(_table(rng, rows, width).astype(np.uint64).sum()) > 2**32  # wraps


@pytest.mark.parametrize("offset,bound", [(0, 40), (40, 40), (80, 17), (13, 1), (0, 97)])
def test_plain_window_is_make_splits_clamped_masked_window(offset, bound):
    """A window that clips on both sides (indices below, inside and above it)."""
    rng = np.random.default_rng(offset * 100 + bound)
    table = _table(rng, 97, 128)
    idx = rng.integers(0, 97, size=400, dtype=np.int32)
    idx[:4] = [offset, offset + bound - 1, max(0, offset - 1), min(96, offset + bound)]
    want = int(_jax_window(table, idx, offset, bound))
    got = rg.row_gather(_t(table[offset : offset + bound]), torch.from_numpy(idx), mode="window",
                        window=(offset, bound))
    assert rg.as_uint32(got) == want


def test_splits_of_a_table_that_does_not_divide_keep_every_row():
    """The JAX tool's windows all hold ``num_rows // s`` rows, so at 13 rows
    and 2 splits its sum drops row 12; the port's last window holds it, and
    every split gives the whole table's checksum."""
    rng = np.random.default_rng(5)
    table = _table(rng, 13, 128)
    idx = np.arange(13, dtype=np.int32)
    whole = int(_jax_total(table, idx))
    bound = 13 // 2
    jax_split = sum(int(_jax_window(table, idx, s * bound, bound)) for s in range(2)) & 0xFFFFFFFF
    assert jax_split != whole
    assert microbench_split.windows(13, 2) == [(0, 6), (6, 7)]
    for s in (2, 3, 4):
        assert int(microbench_split.split_sum(_t(table), torch.from_numpy(idx), s)) == whole


def test_row_gather_checks_its_arguments():
    table, idx = torch.zeros((8, 32), dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    for args, kwargs in (
        ((torch.zeros((8, 30), dtype=torch.int32), idx), {}),
        ((table.long(), idx), {}),
        ((table, idx.long()), {}),
        ((table, idx), {"mode": "rows"}),
        ((table, idx), {"mode": "window"}),
        ((table, idx), {"window": (0, 4)}),
        ((table, idx), {"mode": "window", "window": (0, 9)}),
        ((table, idx), {"mode": "window", "window": (-1, 4)}),
    ):
        with pytest.raises(ValueError):
            rg.row_gather(*args, **kwargs)
    # outside the window mode an index out of range reads the nearest row
    table = torch.arange(8 * 32, dtype=torch.int32).reshape(8, 32)
    ends = rg.row_gather(table, torch.tensor([-5, 0, 7, 99], dtype=torch.int32), mode="per_row")
    assert ends.tolist() == [int(table[0].sum()), int(table[0].sum()), int(table[7].sum()), int(table[7].sum())]


def test_row_gather_launches_its_kernel_for_a_tensor_off_the_cpu(monkeypatch):
    """For a tensor that is not on the CPU (here on the ``meta`` device) the
    wrapper launches K9, never its plain version, once a call, and not at
    all for no indices."""
    calls = []
    monkeypatch.setattr(_kernels, "entry", lambda name: lambda *args: calls.append((name, args)) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(rg, "row_gather_plain", lambda *a, **k: pytest.fail("fell back to the plain version"))
    meta = torch.device("meta")
    table = torch.empty((64, 128), dtype=torch.int32, device=meta)
    idx = torch.empty(10, dtype=torch.int32, device=meta)
    before = rg.row_gather.launches
    assert rg.row_gather(table, idx).shape == ()
    assert rg.row_gather(table, idx, mode="per_row").shape == (10,)
    rg.row_gather(table, idx, mode="window", window=(5, 32))
    rg.row_gather(table, idx[:0])
    assert rg.row_gather.launches - before == 3
    assert [c[0] for c in calls] == ["row_gather"] * 3
    assert [c[1][3:9] for c in calls] == [(10, 64, 128, 0, 0, 0), (10, 64, 128, 1, 0, 0), (10, 64, 128, 2, 5, 32)]


def test_gather_grid_prints_the_jax_tools_columns(capsys):
    header = "table_mb,row_bytes,gathers_per_s,GB_per_s"
    assert f'print("{header}")' in (ROOT / "tools" / "microbench_gather.py").read_text(encoding="utf-8")
    rows = microbench_gather.run(n=64, iters=1, device="cpu", table_mb=(0.02, 0.05), row_bytes=(128, 4096))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == header and len(out) == 1 + len(rows) == 5
    for line, row in zip(out[1:], rows):
        assert line.split(",")[:2] == [f"{row['table_mb']}", f"{row['row_bytes']}"]
        assert line.split(",")[2].endswith("M")


def test_sorted_gather_checksums_agree_with_the_jax_program(capsys):
    """Random, sorted and the sort -> per-row gather -> sort back pipeline
    give one checksum, which is the JAX program's on the tool's own draws
    (``default_rng(0)``)."""
    res = microbench_sorted_gather.run(n=200, iters=1, device="cpu", table_mb=(0.02, 0.03))
    rng = np.random.default_rng(0)
    for row in res["rows"]:
        num_rows = int(row["table_mb"] * 1e6 / 512)
        table = _table(rng, num_rows, 128)
        idx = rng.integers(0, num_rows, size=200, dtype=np.int32)
        assert set(row["checksums"]) == {int(_jax_total(table, idx))}
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "table_mb,random_M/s,sorted_M/s,pipeline_M/s"
    assert "sort 1 payload:" in out and "sort 3 payloads:" in out
    k = torch.tensor([5, 1, 3], dtype=torch.int32)
    sk, p = microbench_sorted_gather.sort_payloads(k, torch.tensor([50, 10, 30], dtype=torch.int32))
    assert sk.tolist() == [1, 3, 5] and p.tolist() == [10, 30, 50]


def test_split_checksums_equal_the_jax_tools(capsys, monkeypatch):
    """At a table whose rows divide by 2, 3 and 4 (12 rows) the JAX tool's
    printed checksums, whole and split, are the port's."""
    argv = ["--table-mb", "0.006144", "--n", "64", "--iters", "1"]
    monkeypatch.setattr("sys.argv", ["microbench_split.py", *argv])
    _jax_tool("microbench_split").main()
    want = re.findall(r"checksum (\d+)", capsys.readouterr().out)
    assert microbench_split.main([*argv, "--device", "cpu"]) == 0
    got = re.findall(r"checksum (\d+)", capsys.readouterr().out)
    assert got == want and len(set(got)) == 1 and len(got) == 4


def test_blockshard_windows_sum_to_the_whole_table(monkeypatch):
    monkeypatch.setattr(microbench_blockshard, "READS_PER_CHUNK", 64)
    res = microbench_blockshard.run(reads=200, classes=3, genome_mb=0.02, iters=1, device="cpu")
    assert res["tiles_equal"] == {2: True, 4: True, 8: True}
    assert res["whole"][0] > 0 and all(res[n][0] > 0 for n in (2, 4, 8))


def test_fields_variants_are_the_jax_tools(capsys):
    jax_names = re.findall(r'^        "(\w+)": ', (ROOT / "tools" / "microbench_fields.py").read_text(encoding="utf-8"),
                           re.MULTILINE)
    rates = microbench_fields.run(table_mb=0.2, reads=64, reads_per_chunk=32, iters=1, device="cpu")
    assert list(rates) == jax_names and len(jax_names) == 13
    assert {n for n, r in rates.items() if r is None} == set(microbench_fields.NO_COUNTERPART)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == jax_names


@pytest.mark.parametrize("tool,argv", [
    (recalibrate_constants, ["--sizes-mb", "0.1", "--n", "8"]),
    (microbench_gather, ["--n", "8"]),
    (microbench_sorted_gather, ["--n", "8"]),
    (microbench_split, ["--table-mb", "0.1", "--n", "8"]),
    (microbench_blockshard, ["--reads", "8", "--classes", "2", "--genome-mb", "0.01"]),
    (microbench_fields, ["--table-mb", "0.1", "--reads", "8", "--reads-per-chunk", "8"]),
])
def test_tools_need_cuda_unless_asked_for_cpu(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(argv)
