"""BENCHMARK.json keeps to the benchmark's contract, and every cell finds
its files by name."""

import json
import re

import pytest

from pbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and BENCH["run_seconds"] == int(BENCH["run_seconds"])
    # a full check of 24 cells fits its 43,200 s
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43_200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(w):
    cell = spec.resolve(w)
    entry = {x["name"]: x for x in BENCH["workloads"]}[w]
    assert entry["chips"] in (1, 4) and 1 <= len(entry["why"]) <= 200
    cfg_entry = {c["name"]: c for c in BENCH["configs"]}[entry["config"]]
    assert cell.config["name"] == cfg_entry["name"]
    assert sorted(cfg_entry["reduced"]) == sorted(cell.config["reduced"])
    assert cell.traffic["mode"] in ("adaptive", "encke")
    assert cell.limits_path.exists()
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
    assert cell.per_layer


def test_every_config_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and c["source"].startswith("https://")
