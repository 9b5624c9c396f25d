"""The check fails a broken timed path: the control, and planted faults.

Each test drives a whole tiny run on the CPU past the harness's look for
a card, with the program broken underneath, and sees ``correct`` false.
The faults a classification cell can have: an answer altered where it is
produced (a hit count, the SVM's label), half of a batch left out, and a
request that fails.  (A training step and an exchange between chips are
not on these cells' paths.)
"""

import pytest
import torch

from bench_port import control, harness
from bench_port.tests import tiny
from xspect2_tpu_torch.models.filter_model import ProbabilisticFilterModel
from xspect2_tpu_torch.models.svm_head import SVMHead
from xspect2_tpu_torch.ops.query import DeviceQueryEngine


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_control_fails_the_check_and_the_program_passes(tmp_path, cell):
    got = control.readings(tiny.plan(cell), tiny.SEED, 0.3, "cpu", work_root=tmp_path)
    assert got["program"]["correct"] and got["program"]["wrong_answers"] == 0
    # one probe fewer: false positives the stated index does not give
    assert not got["control"]["correct"] and got["control"]["wrong_answers"] >= 3
    if cell.startswith("species"):
        assert got["program"]["head_gap"] <= harness.HEAD_GAP_LIMIT
        # the head in float32 in the program's place: its decisions miss
        assert not got["head_float32"]["correct"]
        assert got["head_float32"]["head_gap"] > harness.HEAD_GAP_LIMIT
    else:
        assert "head_gap" not in got["program"] and "head_float32" not in got


def _broken(monkeypatch, owner, method, change):
    inner = getattr(owner, method)

    def broken(self, *args, **kwargs):
        return change(inner(self, *args, **kwargs))

    monkeypatch.setattr(owner, method, broken)


def _one_count_off(out):
    out = out.clone() if isinstance(out, torch.Tensor) else out.copy()
    out[0, 0] += 1
    return out


def _half_left_out(out):
    out = out.clone() if isinstance(out, torch.Tensor) else out.copy()
    out[len(out) // 2 :] = 0
    return out


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("fault", [_one_count_off, _half_left_out], ids=["answer_altered", "half_left_out"])
def test_a_broken_lookup_is_not_correct(tmp_path, monkeypatch, cell, fault):
    # the reads route's counts of a file, or the records route's of a batch
    if cell.endswith("reads"):
        _broken(monkeypatch, ProbabilisticFilterModel, "_count_reads", fault)
    else:
        _broken(monkeypatch, DeviceQueryEngine, "count_hits", fault)
    res = tiny.run(cell, tmp_path=tmp_path)
    assert not res["correct"] and res["checks"]["wrong_answers"]["value"] >= 1


def test_an_altered_species_label_is_not_correct(tmp_path, monkeypatch):
    inner = SVMHead.predict
    monkeypatch.setattr(SVMHead, "predict", lambda self, x: [self.classes[-1] if c != self.classes[-1]
                                                             else self.classes[0] for c in inner(self, x)])
    res = tiny.run("species40-assemblies", tmp_path=tmp_path)
    assert not res["correct"] and res["checks"]["wrong_answers"]["value"] >= 1


@pytest.mark.parametrize("cell", ["species40-reads", "species40-assemblies"])
def test_head_decisions_in_float32_are_not_correct(tmp_path, monkeypatch, cell):
    from xspect2_tpu_torch.models import svm_head as head_module

    inner = head_module.svm_head

    def float32_decisions(head, x, **kwargs):
        pred, dec = inner(head, x, **kwargs)
        return pred, None if dec is None else dec.float().double()

    monkeypatch.setattr(head_module, "svm_head", float32_decisions)
    res = tiny.run(cell, tmp_path=tmp_path)
    assert not res["correct"] and res["checks"]["head_gap"]["value"] > harness.HEAD_GAP_LIMIT


def test_a_failed_request_is_not_correct(tmp_path, monkeypatch):
    from xspect2_tpu_torch.models.result import ModelResult

    inner, calls = ModelResult.save, []

    def save(self, path):
        calls.append(path)
        if len(calls) == tiny.ASSEMBLIES["pool_files"] + 2:  # the warm-up's pass, then the window's second
            raise OSError("disk full")
        return inner(self, path)

    monkeypatch.setattr(ModelResult, "save", save)
    res = tiny.run("species40-assemblies", tmp_path=tmp_path)
    assert not res["correct"] and res["failed"] == 1 and res["checks"]["wrong_answers"]["value"] >= 1
