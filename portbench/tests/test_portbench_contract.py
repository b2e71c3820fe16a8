"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix, limit and metric found by its name."""
from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import bench

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_paths():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    b = _bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in b["workloads"]:
        cell = bench.find_cell(REPO, w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in got
        for m in cell.end_to_end + cell.per_layer:
            assert os.path.exists(cell.metric_path(m["name"]))
        assert os.path.exists(os.path.join(
            REPO, "portbench", "generators", cell.traffic["kind"] + ".py"))
        assert cell.limits
    for m in b["end_to_end"] + b["per_layer"]:
        for w in m.get("workloads", ()):
            assert w in {x["name"] for x in b["workloads"]}


def test_configs_state_what_the_program_runs():
    """Each configuration file's model block equals the port's preset at
    its dataset geometry (port_config raises on a difference)."""
    b = _bench()
    for c in b["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        port = bench.port_config(cfg, "")
        assert port.training.batch_size_train == cfg["training"]["batch_size"]
        for k in c["reduced"]:
            assert k in cfg and k in cfg.get("published", {})


def test_added_files_are_found_without_edits(tmp_path):
    """A configuration, traffic mix, limit, metric and cell added as new
    files and entries are found by their names."""
    root = str(tmp_path)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "rvt_b_gen1.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "throwaway"
    with open(os.path.join(pb, "configs", "throwaway.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(pb, "traffic", "eval_b16.json"),
                os.path.join(pb, "traffic", "throwaway_mix.json"))
    with open(os.path.join(pb, "limits", "throwaway_cell.json"), "w") as f:
        json.dump({"score_gap": 1.0}, f)
    with open(os.path.join(pb, "metrics", "throwaway_metric.py"), "w") as f:
        f.write("def read(run):\n    return 2.0 * run.window_s\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "throwaway", "source": "x", "reduced": [],
                         "file": "portbench/configs/throwaway.json",
                         "why": "x"})
    b["workloads"].append({"name": "throwaway_cell", "config": "throwaway",
                           "traffic": "throwaway_mix", "chips": 1,
                           "why": "x"})
    b["per_layer"].append({"name": "throwaway_metric", "unit": "s",
                           "better": "lower", "source": "host_clock",
                           "layer": "device", "moves": "setup_s",
                           "workloads": ["throwaway_cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    cell = bench.find_cell(root, "throwaway_cell")
    assert cell.config["name"] == "throwaway"
    assert cell.limits == {"score_gap": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["throwaway_metric"]
    assert bench.generator(cell).__name__.endswith("eval_stream")
    run = bench.Run(window_s=3.0)
    assert bench.read_metric(cell, "throwaway_metric", run) == 6.0
    with pytest.raises(KeyError):
        bench.find_cell(root, "no_such_cell")


def test_judge_holds_every_number_to_its_limit():
    run = bench.Run(checks=[("a", 0.1), ("b", 0.0)])
    assert bench.judge(run, {"a": 0.2, "b": 0.0})[0]
    assert not bench.judge(run, {"a": 0.05, "b": 0.0})[0]
    assert not bench.judge(run, {"a": 0.2})[0]           # no limit
    assert not bench.judge(bench.Run(checks=[("a", float("nan"))]),
                           {"a": 1.0})[0]
    assert not bench.judge(bench.Run(), {})[0]          # nothing compared


@pytest.mark.parametrize("name", ["train_kernel_ms_per_frame",
                                  "offline_kernel_ms_per_frame"])
def test_kernel_time_a_frame_leaves_out_copies(name):
    """The end-to-end kernel time a frame: the union of the kernels'
    intervals over the profiled frames, copies and fills left out, and
    nothing where no stretch was profiled."""
    from portbench import trace
    w = trace.Window.__new__(trace.Window)
    w.device = [("block_mlp_kernel<64>", 0.0, 3000.0),
                ("layer_norm", 2000.0, 5000.0),        # overlaps: 5 ms
                ("Memcpy HtoD (Pageable -> Device)", 5000.0, 9000.0),
                ("Memset (Device)", 9000.0, 9500.0),
                ("elementwise", 10000.0, 11000.0)]      # us
    cell = bench.find_cell(REPO, {"train": "gen4_train_b12",
                                  "offline": "gen1_eval_b16"}[
                                      name.split("_")[0]])
    run = bench.Run(trace={"window": w}, values={"profiled_frames": 4})
    assert bench.read_metric(cell, name, run) == pytest.approx(1.5)
    assert bench.read_metric(cell, name, bench.Run(
        values={"profiled_frames": 4})) is None
    assert bench.read_metric(cell, name, bench.Run(
        trace={"window": w})) is None
