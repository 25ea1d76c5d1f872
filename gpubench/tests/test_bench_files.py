"""BENCHMARK.json's shape, and every file it names found by name."""

import json
import os
import re

import pytest

from gpubench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_bench()


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_bounds():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in BENCH["workloads"]:
        e2e = harness.cell_metrics(BENCH, cell["name"], trace=False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, cell["name"], trace=True)
        assert cell["chips"] == 1 and len(cell["why"]) <= 200


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_files_load_by_name(cell):
    entry, cfg, traffic, limits = harness.find_cell(BENCH, cell)
    assert cfg["name"] == entry["config"]
    loop = harness.driver(traffic["driver"])
    assert callable(loop.window) and callable(loop.check) and callable(loop.joseph_uses)
    assert callable(harness.reference(cfg).model_sizes) and callable(harness.weights(traffic))
    assert callable(harness.dataset(cfg))
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    from gpubench.drivers._common import port_config

    assert port_config(cfg).batch_size == cfg["batch_size"]  # every key is the port's or the harness's


def test_window_settings_live_in_the_traffic_files_alone():
    for c in BENCH["configs"]:
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert not {"steps_per_call", "metrics_every", "driver", "weights"} & set(cfg)


@pytest.mark.parametrize("name", ["../run", "drivers.train", "", "1x"])
def test_only_module_names_are_looked_up(name):
    with pytest.raises(ValueError):
        harness.driver(name)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_load_by_name(metric):
    assert callable(harness.metric_reader(metric))


def test_config_files_are_unique_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("gpubench/")
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
