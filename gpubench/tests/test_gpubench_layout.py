"""BENCHMARK.json against the benchmark's contract, and every name in it
against its files."""

import json
import re

import pytest

from gpubench import layout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = layout.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"][:3] == ["python3", "-m", "gpubench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24      # the most cells a later check may hold
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) \
        + cells * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"] == "gpubench/configs/{}.json".format(entry["name"])
    cfg = json.loads((layout.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == \
        entry["reduced"] == []
    for kind in ("reference", "counts"):
        assert (layout.HERE / kind / (entry["name"] + ".py")).exists()
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_and_reports(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    info = layout.cell(cell["name"])
    assert info["traffic"]["kind"] in ("serve", "train")
    e2e = [m["name"] for m in layout.metrics_for(cell["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = layout.metrics_for(cell["name"], True)
    assert layers
    for m in layers:
        assert m["moves"] in e2e
        assert (layout.HERE / "metrics" / (m["name"] + ".py")).exists()
    assert set(info["limits"]) and all(
        isinstance(v, (int, float)) for v in info["limits"].values())


def test_metrics_follow_the_contract():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layer_names = {}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells
        layer_names.setdefault(m["layer"].lower(), m["layer"])
        assert layer_names[m["layer"].lower()] == m["layer"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]


def test_module_files_load():
    for m in BENCH["per_layer"]:
        assert callable(layout.module("metrics", m["name"]).read)
    for c in BENCH["configs"]:
        assert callable(layout.module("reference", c["name"]).forward)


@pytest.mark.parametrize("change", [{"loop": "open"}, {"clients": 4},
                                    {"arrivals": "poisson"}],
                         ids=["loop", "clients", "unknown"])
def test_generator_refuses_what_it_does_not_implement(change):
    from gpubench.run import driver

    info = layout.cell("mamba-h13.serve")
    info["traffic"].update(change)
    with pytest.raises(ValueError):
        driver(info, 1, "cpu")
