"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by name."""

import json
import os
import re

import pytest

from benchmark.harness import check
from benchmark.harness.manifest import Manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state_size|proj|head|expan|per_tok|layer_sizes|intention_size")


@pytest.fixture(scope="module")
def manifest():
    return Manifest(ROOT)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(manifest):
    d = manifest.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert d["command"] == ["python3", "benchmark/run.py"]
    assert d["paths"] == ["benchmark"]
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs(manifest):
    names = set()
    for c in manifest.data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and c["source"].startswith("https://") and _line(c["why"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not [k for k in c["reduced"] if WIDTH.search(k.split(".")[-1])], "reduced names a width"
        f = manifest.config_file(c["name"])
        assert f["config_name"] == c["name"] and f["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "configs", c["name"] + ".npz"))


def test_workloads_find_their_files(manifest):
    configs = {c["name"] for c in manifest.data["configs"]}
    seen = set()
    for w in manifest.data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and _line(w["why"])
        traffic = manifest.traffic(w["traffic"])
        assert traffic["checked_control_step"][0] == traffic["window_opens_at_step"]
        limits = check.load_limits(ROOT, w["name"])
        assert set(limits) == set(check.NAMES)
        assert manifest.end_to_end(w["name"]), "every cell reports an end-to-end metric"
        assert manifest.per_layer(w["name"]), "every cell reports a per-layer metric"
    assert {c for _, c in ((w["traffic"], w["config"]) for w in manifest.data["workloads"])} == configs


def test_metrics(manifest):
    d = manifest.data
    e2e = {m["name"] for m in d["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    workloads = {w["name"] for w in d["workloads"]}
    for m in d["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in d["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and m["name"] not in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"]) and set(m["workloads"]) <= workloads
        assert callable(manifest.reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    names = [m["name"] for m in d["per_layer"]] + list(e2e)
    assert len(names) == len(set(names))
    assert any("mfu" in n for n in names)


def test_cell_files_are_named_from_names(manifest):
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            if "__pycache__" in rel:
                continue
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel


def test_manifest_json_round_trips():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        json.load(f)


def test_a_traffic_that_copies_inside_the_window_is_refused(manifest):
    from benchmark.harness import cell

    w = manifest.workload("rodent-spa-wide")
    traffic = dict(manifest.traffic(w["traffic"]))
    traffic["checked_steps"] = traffic["window_opens_at_step"] + 1
    with pytest.raises(ValueError, match="inside the window"):
        cell.make_plan(manifest.config_file(w["config"]), traffic)
