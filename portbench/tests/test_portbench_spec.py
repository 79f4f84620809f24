"""``BENCHMARK.json`` against the benchmark's contract, and a cell, a
configuration and a per-layer metric added as new files only, picked up
by name."""

import json
import os
import re
import shutil

import pytest

from portbench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    s = spec.bench_spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["portbench"]
    assert s["command"] == ["python3", "portbench/run.py"]
    assert 1 <= s["run_seconds"] <= 51
    configs = {c["name"] for c in s["configs"]}
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
    cells = [w["name"] for w in s["workloads"]]
    assert len(set(cells)) == len(cells)
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(
        1, len(cells) // 4)
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200
        cell = spec.load_cell(w["name"])
        assert cell.limits and cell.end_to_end and cell.per_layer
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in names
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] == "train_images_per_s"
        assert set(m["workloads"]) <= set(cells) and m["workloads"]
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"]
        assert os.path.isfile(os.path.join(spec.BENCH_DIR, "metrics",
                                           f"{m['name']}.py"))
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        < 64 * 1024


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


def test_new_files_are_picked_up_by_name(tmp_path, monkeypatch):
    bench = tmp_path / "portbench"
    shutil.copytree(spec.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    s = spec.bench_spec()
    # a configuration, a traffic mix, a cell's limits and a per-layer
    # metric: new files only
    (bench / "configs" / "cnn_copy.json").write_text(
        (bench / "configs" / "cnn.json").read_text())
    (bench / "traffic" / "b512.json").write_text(json.dumps(
        {"batch_size": 512, "train_images": 60000, "test_images": 10000}))
    (bench / "limits" / "cnn_copy-b512.json").write_text(json.dumps(
        {"eval_loss_gap": 1e-3}))
    (bench / "metrics" / "epoch.count.py").write_text(
        "def read(ctx):\n    return float(ctx.epochs)\n")
    s["configs"].append({"name": "cnn_copy", "source": "https://example.org",
                         "file": "portbench/configs/cnn_copy.json",
                         "reduced": [], "why": "a copy"})
    s["workloads"].append({"name": "cnn_copy-b512", "config": "cnn_copy",
                           "traffic": "b512", "chips": 1, "why": "a test"})
    s["per_layer"].append({"name": "epoch.count", "unit": "epochs",
                           "better": "higher", "source": "host_clock",
                           "layer": "epoch loop",
                           "moves": "train_images_per_s",
                           "workloads": ["cnn_copy-b512"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    monkeypatch.setattr(spec, "BENCH_DIR", str(bench))
    cell = spec.load_cell("cnn_copy-b512", root=str(tmp_path))
    assert cell.traffic["batch_size"] == 512
    assert cell.config["model"] == "cnn"
    assert cell.limits == {"eval_loss_gap": 1e-3}
    assert [m["name"] for m in cell.per_layer] == ["epoch.count"]
    reader = spec.load_module("metrics", "epoch.count")
    assert reader.read(type("Ctx", (), {"epochs": 3})) == 3.0
    # the cells already there are unchanged
    assert "epoch.count" not in [
        m["name"] for m in spec.load_cell("cnn-b256",
                                          root=str(tmp_path)).per_layer]
