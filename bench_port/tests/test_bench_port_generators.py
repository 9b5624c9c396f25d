"""The traffic and data generators repeat exactly for one seed."""

import hashlib

import numpy as np
import pytest

from bench_port import harness, synthetic
from bench_port.tests import tiny


def _digest(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.read_bytes())
    return h.hexdigest()


def test_genomes_reads_and_assemblies_repeat_for_one_seed():
    def draw(seed):
        rng = np.random.default_rng(seed)
        g = synthetic.make_genomes(rng, 3, 5_000)
        reads, cls = synthetic.simulate_reads(g, 200, rng)
        asm = synthetic.simulate_assembly(g[1], rng, "a", 7)
        return g, reads, cls, asm

    a, b, c = draw(2**31 + 3), draw(2**31 + 3), draw(5)
    for x, y in zip(a[:3], b[:3]):
        assert np.array_equal(x, y)
    assert [(i, s.tobytes()) for i, s in a[3]] == [(i, s.tobytes()) for i, s in b[3]]
    assert not np.array_equal(a[1], c[1])


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_training_files_and_pool_repeat_for_one_seed(tmp_path, cell):
    plan = tiny.plan(cell)

    def files(seed, where):
        rng = np.random.default_rng(seed)
        genomes, _, _ = plan["kind"].make_training(plan["config"], rng, where / "train")
        pool = harness.make_pool(plan["traffic"], genomes, rng, where / "pool", plan["config"]["k"])
        return sorted(where.rglob("*.fast*")), pool

    one, pool_one = files(tiny.SEED, tmp_path / "one")
    two, _ = files(tiny.SEED, tmp_path / "two")
    other, pool_other = files(tiny.SEED + 1, tmp_path / "other")
    assert [p.relative_to(tmp_path / "one") for p in one] == [p.relative_to(tmp_path / "two") for p in two]
    assert _digest(one) == _digest(two)
    assert _digest(one) != _digest(other)
    # another seed sends the same amount of work, in another order
    assert sorted(p.n_records for p in pool_one) == sorted(p.n_records for p in pool_other)


def test_fastq_writer_gives_the_ids_it_returns(tmp_path):
    reads = np.array([[0, 1, 2, 3, 255]] * 12, dtype=np.uint8)
    ids = synthetic.write_fastq(tmp_path / "r.fastq", reads, "x")
    lines = (tmp_path / "r.fastq").read_text().splitlines()
    assert lines[0::4] == [f"@{i}" for i in ids] and ids[0] == "x00" and ids[-1] == "x11"
    assert set(lines[1::4]) == {"ACGTN"} and set(lines[2::4]) == {"+"} and set(lines[3::4]) == {"IIIII"}
