"""BENCHMARK.json keeps to the benchmark's format rules, and every name it
holds finds its files."""

import json
import math
import os
import re

import pytest

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert not any(w.startswith("/") for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, each allowed run_seconds + 60
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_name_and_unit_uses_the_allowed_characters():
    b = _bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len({c["name"] for c in b["configs"]}) == len(b["configs"])
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_entries_have_just_their_keys():
    b = _bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])


def test_every_cell_finds_its_files_and_reports_what_it_must():
    b = _bench()
    here = os.path.join(ROOT, "portbench")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in b["workloads"]:
        traffic = os.path.join(here, "traffic", f"{w['traffic']}.json")
        with open(traffic) as f:
            kind = json.load(f)["kind"]
        assert os.path.isfile(os.path.join(here, "traffic", f"{kind}.py"))
        assert os.path.isfile(os.path.join(here, "reference", "limits", f"{w['name']}.json"))
        reported = [n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        layer = [m for m in b["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        for m in layer:
            assert m["moves"] in reported
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(here, "metrics", f"{m['name']}.py"))
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in b["workloads"]}


@pytest.mark.parametrize("name", ["igmc-ml1m", "igmc-yahoo"])
def test_configuration_files_state_their_cut(name):
    b = _bench()
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    entry = next((c for c in b["configs"] if c["name"] == name), None)
    assert entry is None or cfg["reduced"] == entry["reduced"]
    assert set(cfg["reduced"]) <= set(cfg["assumed"])
    m = cfg["model"]
    assert m["latent_dim"] == [32, 32, 32, 32] and m["num_bases"] == 4
    assert m["num_features"] == 2 * m["hops"] + 2 and not m["tf32"]
    assert math.isclose(m["arr"], 0.001) and m["batch_size"] == 50
