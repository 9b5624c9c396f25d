"""The window's arithmetic: no file cut, all work over all the time, the tail."""

import time
from pathlib import Path

import pytest

from bench_port import harness
from bench_port.measure import Request, Run, percentile


class _File:
    def __init__(self, n):
        self.path = Path(f"f{n}.fastq")
        self.n_records = n


def test_window_starts_files_while_time_is_left_and_cuts_none(tmp_path):
    pool = [_File(10), _File(20), _File(30)]
    written = []

    def call(path, out, device):
        time.sleep(0.05)
        written.append(out.name)

    reqs = harness.run_requests(call, pool, tmp_path, "cpu", seconds=0.22)
    # files started while < 0.22 s had passed: 5 of 0.05 s (the fifth at ~0.2 s) ran to their end
    assert 4 <= len(reqs) <= 6
    assert written == [f"{r.index:05d}.json" for r in reqs]
    assert [r.pool_index for r in reqs] == [i % 3 for i in range(len(reqs))]
    assert reqs[-1].t0 - reqs[0].t0 < 0.22 <= reqs[-1].t1 - reqs[0].t0 + 0.05
    assert all(r.ok for r in reqs)


def test_a_failed_request_is_counted_and_the_window_goes_on(tmp_path):
    calls = []

    def call(path, out, device):
        calls.append(path)
        if len(calls) == 2:
            raise RuntimeError("boom")

    reqs = harness.run_requests(call, [_File(5)], tmp_path, "cpu", None, count=4)
    assert [r.ok for r in reqs] == [True, False, True, True]
    assert "boom" in reqs[1].error


def _run(times, records, window_s):
    reqs = [Request(i, 0, n, t0, t1, True) for i, ((t0, t1), n) in enumerate(zip(times, records))]
    return Run(setup_s=1.0, window_s=window_s, requests=reqs, work={"reads": sum(records)})


def test_rate_is_all_work_over_the_whole_window():
    run = _run([(0.0, 1.0), (1.0, 3.0), (3.0, 3.5)], [100, 300, 50], 3.5)
    assert run.rate("reads") == pytest.approx(450 / 3.5)
    assert run.rate("assemblies") is None
    assert run.per("reads", 0.9, 1e6) == pytest.approx(2000.0)
    assert run.per("reads", None, 1e6) is None


def test_p95_is_the_nearest_rank_of_every_request():
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile(list(range(1, 21)), 95) == 19
    assert percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        percentile([], 95)
    times = [(i, i + (i + 1) / 1000) for i in range(200)]  # 1 ms .. 200 ms
    run = _run(times, [1] * 200, 300.0)
    assert run.request_p95_ms() == pytest.approx(190.0)
    run.requests[-1].ok = False  # a failed request is no sample of the tail
    assert run.request_p95_ms() == pytest.approx(190.0)  # ceil(0.95 * 199) = 190th of 199
