"""BENCHMARK.json keeps to the benchmark format's limits, and every name it gives
has its file: a configuration, a traffic mix, a metric's reader."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32 and all(LINE.match(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_and_unit_uses_only_the_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in METRICS] + [w["config"] for w in SPEC["workloads"]]
    names += [w["traffic"] for w in SPEC["workloads"]] + [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_a_configuration_has_its_own_file_with_what_it_reduced(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert LINE.match(config["source"]) and LINE.match(config["why"]) and len(config["reduced"]) <= 16
    assert config["file"].startswith("bench_port/configs/")
    body = json.loads((ROOT / config["file"]).read_text(encoding="utf-8"))
    assert body["name"] == config["name"] and body["reduced"] == config["reduced"]
    assert set(config["reduced"]) <= set(body["upstream"]) and all(k in body for k in config["reduced"])
    assert not any(k.endswith(("_dim", "_rank")) for k in config["reduced"])
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
    assert (ROOT / body["reference"]).exists()


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_a_cell_has_its_traffic_file_and_reports_what_it_must(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"} and cell["chips"] in (1, 4)
    assert LINE.match(cell["why"])
    assert (ROOT / "bench_port" / "traffic" / f"{cell['traffic']}.json").exists()
    e2e = [m for m in SPEC["end_to_end"] if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    per = [m for m in SPEC["per_layer"] if cell["name"] in m.get("workloads", [])]
    assert per and all(m["moves"] in {e["name"] for e in e2e} for m in per)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_a_metric_has_its_reader_and_the_keys_of_its_kind(metric):
    assert (ROOT / "bench_port" / "metrics" / f"{metric['name']}.py").exists()
    if metric in SPEC["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        if metric["name"].endswith("_roofline") or "_roofline." in metric["name"]:
            assert metric["unit"] == "%"


def test_metrics_of_one_layer_name_it_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"facade and result", "model", "SVM head", "host wire", "engine", "kernels", "device"}


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
