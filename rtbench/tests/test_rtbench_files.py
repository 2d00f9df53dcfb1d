"""BENCHMARK.json against the contract, and every file it names found by
name."""

import json
import re

import pytest

from rtbench import core, scenes
from rtbench.tests.common import BENCH, CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "rtbench/run.py"]
    assert BENCH["paths"] == ["rtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_cells_and_configurations():
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_entries_have_the_contract_keys_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    names = set()
    for section, want in keys.items():
        for e in BENCH[section]:
            assert set(e) - {"workloads"} == want, (section, e)
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
            for k in ("why", "source", "layer"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", [w])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_the_contract_asks(cell):
    _, entry, config, traffic, per_layer, end_to_end = core.find_cell(cell)
    names = {m["name"] for m in end_to_end}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert core.limits(cell)
    drv = core.driver(traffic)
    assert hasattr(drv, "Cell") and set(drv.SMALL) <= set(traffic)
    kind = scenes.kind(config["scene"]["kind"])
    assert callable(kind.make) and set(kind.SMALL) <= set(config["scene"])
    assert (ROOT / "rtbench" / "traffic" / f"{cell_traffic(cell)}.json"
            ).exists()


def test_every_named_file_loads():
    for m in BENCH["per_layer"]:
        mod = core.load_module(core.HERE / "metrics" / f"{m['name']}.py")
        assert callable(mod.read)
    for mod in core.rooflines().values():
        assert mod.KERNELS and callable(mod.launch_bytes)
        assert callable(mod.live) and len(mod.PROBE) == 2
    for c in BENCH["configs"]:
        assert c["file"].startswith("rtbench/configs/")
        json.loads((ROOT / c["file"]).read_text())


def cell_traffic(cell):
    return {w["name"]: w["traffic"] for w in BENCH["workloads"]}[cell]


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        core.find_cell("terrain16k-nothing")
