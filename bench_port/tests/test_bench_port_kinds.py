"""The kind of model is a plug-in of the harness (``kinds/<facade>.py``).

Moving the species and genus steps out of the harness changed no cell:
at tiny size, the pool's bytes, the window's kernel bounds, the sampled
requests and the check's numbers are those the harness gave before the
move (``FROZEN``, taken from the harness of the commit before it, in a
``git archive`` copy of that commit, by :func:`digests` with that
copy's ``bench_port`` first on ``sys.path``).  A kind added as a new
file needs no edit of the harness, and the harness and the control
branch on no kind.
"""

import hashlib
import re
import shutil
import time

import pytest
import torch

from bench_port import harness
from bench_port.tests import tiny

# by cell: sha256 of the pool files' bytes, Run.bounds (repr of the
# seconds), the sampled request indices, the checks
FROZEN = {
    "genus160-assemblies": {
        "pool": "3ee713b95af292f9c4498830efa5c8cbf41e1d64ac4a5b6d28b2d7c49fad22fa",
        "bounds": {"records_query_kernel": "3.382944504406666e-07"},
        "sample": [3, 1],
        "checks": {"wrong_answers": {"value": 0, "limit": 0}},
    },
    "genus160-reads": {
        "pool": "00bd296c2dabd968625deda2340b78e6dd5f163fd512ffe094e0c78bf9ad2e83",
        "bounds": {"reads_query_kernel": "4.934790447761194e-07"},
        "sample": [0],
        "checks": {"wrong_answers": {"value": 0, "limit": 0}},
    },
    "species40-assemblies": {
        "pool": "8c14a5c0ae4c2a0fe9aa1f496556ceeee222c748ed30bbb71a2185ba72b9ec23",
        "bounds": {"records_query_kernel": "3.658048510354206e-07"},
        "sample": [2, 1],
        "checks": {"head_gap": {"value": 1.1102230246251565e-16, "limit": 1e-10},
                   "wrong_answers": {"value": 0, "limit": 0}},
    },
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def digests(bench, plan: dict, work_root) -> dict:
    """A traced tiny run of ``plan`` on the CPU through the harness module
    ``bench``, with a window of a fixed count of requests (the pool's and
    two more), so that its sample and bounds repeat: what it made and
    judged."""
    got, runs = {}, []
    make_pool, run_requests, sample_requests, run_type = (bench.make_pool, bench.run_requests,
                                                          bench.sample_requests, bench.Run)

    def pool_digest(*args, **kwargs):
        pool = make_pool(*args, **kwargs)
        h = hashlib.sha256()
        for pf in pool:
            h.update(pf.path.read_bytes())
        got["pool"] = h.hexdigest()
        return pool

    def counted(call, pool, out_dir, device, seconds, count=None, **kwargs):
        return run_requests(call, pool, out_dir, device, None, len(pool) + 2 if seconds is not None else count,
                            **kwargs)

    def sample(*args, **kwargs):
        out = sample_requests(*args, **kwargs)
        got["sample"] = [r.index for r in out]
        return out

    def kept(*args, **kwargs):
        runs.append(run_type(*args, **kwargs))
        return runs[-1]

    with pytest.MonkeyPatch.context() as mp:
        for attr, fn in (("make_pool", pool_digest), ("run_requests", counted), ("sample_requests", sample),
                         ("Run", kept)):
            mp.setattr(bench, attr, fn)
        res = bench.run_cell(plan, tiny.SEED, 1.0, True, "cpu", time.time(), work_root=work_root)
    (run,) = runs
    got["bounds"] = {kernel: repr(seconds) for kernel, seconds in run.bounds.items()}
    got["checks"] = res["checks"]
    return got


@pytest.mark.parametrize("cell", sorted(FROZEN))
def test_a_cell_runs_as_before_the_kinds_moved_out(tmp_path, cell):
    assert digests(harness, tiny.plan(cell), tmp_path) == FROZEN[cell]


def test_a_kind_added_as_a_new_file_needs_no_harness_edit(tmp_path, monkeypatch):
    kinds = tmp_path / "kinds"
    kinds.mkdir()
    shutil.copy(harness.KINDS / "genus.py", kinds / "genus_copy.py")
    monkeypatch.setattr(harness, "KINDS", kinds)
    cell = "genus160-assemblies"
    overrides = {"config": {**tiny.TINY[cell]["config"], "facade": "genus_copy"},
                 "traffic": tiny.TINY[cell]["traffic"]}
    plan = harness.load_plan(cell, spec=tiny.spec(), overrides=overrides)
    assert plan["kind"].__file__ == str(kinds / "genus_copy.py")
    assert digests(harness, plan, tmp_path) == FROZEN[cell]


@pytest.mark.parametrize("name", ["harness.py", "control.py"])
def test_the_harness_and_the_control_branch_on_no_kind(name):
    source = (harness.BENCH / name).read_text(encoding="utf-8")
    assert not re.search(r"""["'](species|genus)["']|\["svm"\]""", source)
