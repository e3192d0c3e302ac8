"""BENCHMARK.json against the contract's rules of form, and every cell
resolving its files by name."""
from __future__ import annotations

import json
import re

import pytest
from bench_tiny import BENCH, ROOT

from benchlib import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    for w in MAN["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MAN["paths"]), w


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_valid(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    assert len({c["file"] for c in MAN["configs"]}) == len(MAN["configs"])


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(pairs) // 4)
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:   # each listed cell reports the metric it moves
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:   # every cell: setup_s, another end-to-end, a per-layer metric
        c = manifest.load_cell(cell)
        assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_resolves_its_files(cell):
    c = manifest.load_cell(cell)
    assert manifest.kind_module(c).run
    assert c.limits, "every cell has its limits file"
    for m in c.per_layer:
        reader = manifest.metric_reader(c, m["name"])
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
    assert (BENCH / "configs" / f"{c.config['name']}.json").is_file()


def test_every_metric_file_is_listed():
    listed = {m["name"] for m in MAN["per_layer"]}
    files = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert files == listed
