# test_bench_manifest.py — BENCHMARK.json against the rules it is held to,
# and every file it names found by name.
import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_sizes(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert man["paths"] == ["benchmark"]
    assert 1 <= len(man["command"]) <= 32
    for word in man["command"]:
        assert TEXT.match(word) and not word.startswith("/") \
            and ".." not in word
    assert os.path.isfile(os.path.join(ROOT, man["command"][1]))
    assert isinstance(man["run_seconds"], int) and \
        1 <= man["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (man["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_text(man):
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert TEXT.match(e[key]), (e["name"], key)
    assert len(names) == len(set(names))
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def reports(man, kind, metric, cell):
    m = next(e for e in man[kind] if e["name"] == metric)
    return "workloads" not in m or cell in m["workloads"]


def test_moves_names_a_metric_every_cell_of_the_layer_reports(man):
    cells = [w["name"] for w in man["workloads"]]
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(man, "end_to_end", m["moves"], cell), \
                (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer(man):
    for w in man["workloads"]:
        c = w["name"]
        e2e = [m["name"] for m in man["end_to_end"]
               if reports(man, "end_to_end", m["name"], c)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(man, "per_layer", m["name"], c)
                   for m in man["per_layer"])


def test_every_configuration_has_a_cell_and_its_file(man):
    used = {w["config"] for w in man["workloads"]}
    files = set()
    for c in man["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_and_reader_loads_by_name(man):
    from benchlib import common
    for w in man["workloads"]:
        cell = common.load_cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic_name"] == w["traffic"]
        assert cell["chips"] == w["chips"]
        assert os.path.isfile(os.path.join(
            BENCH, "benchlib", f"{cell['config_data']['system']}.py"))
    for m in man["per_layer"]:
        assert callable(common.load_reader(m["name"]))
