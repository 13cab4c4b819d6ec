"""BENCHMARK.json against the contract's shape, and every name it gives
resolved to its file under perfbench/."""
import importlib.util
import json
import os
import re

import pytest

from conftest import BENCH

ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "perfbench/run.py"]
    assert m["paths"] == ["perfbench"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_the_allowed_characters(kind):
    entries = manifest()[kind]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_every_config_resolves_to_its_file():
    for c in manifest()["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        path = os.path.join(ROOT, c["file"])
        with open(path) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert c["reduced"] == conf["reduced"] == []


def test_every_cell_resolves_to_its_files():
    m = manifest()
    configs = {c["name"] for c in m["configs"]}
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        with open(os.path.join(BENCH, "workloads", w["name"] + ".json")) as f:
            cell = json.load(f)
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["why"] == w["why"]
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert set(cell["limits"]) == {"grad_shape_q75_1", "change_3"}
        assert all(0 < v < 1 for v in cell["limits"].values())
        assert os.path.exists(os.path.join(BENCH, "entries", cell["entry"] + ".py"))
    assert configs == {w["config"] for w in m["workloads"]}


def test_every_per_layer_metric_resolves_to_its_reader():
    m = manifest()
    e2e = {e["name"] for e in m["end_to_end"]}
    cells = {w["name"] for w in m["workloads"]}
    assert "setup_s" in e2e
    for e in m["per_layer"]:
        spec = importlib.util.spec_from_file_location(
            "m", os.path.join(BENCH, "metrics", e["name"] + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
            e["layer"], e["unit"], e["better"], e["source"], e["moves"])
        assert e["moves"] in e2e and set(e["workloads"]) <= cells
        assert callable(mod.read)
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    m = manifest()
    for w in m["workloads"]:
        e2e = [e["name"] for e in m["end_to_end"] if w["name"] in e.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in e.get("workloads", []) for e in m["per_layer"])
