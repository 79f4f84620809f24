"""A tiny cell end to end on the CPU through the harness, with the port's
plain kernel versions: the result's line, the faults that must make
``correct`` false, and the control, which must fail a number. The card's
run of a real cell is the ``cuda`` test at the end."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import control, run
from portbench.core import check, session, spec


def tiny_cell(name):
    """``name``'s configuration, limits and batch, with four train steps
    an epoch and 1000 test images: a size a test run holds."""
    cell = spec.load_cell(name)
    batch = cell.traffic["batch_size"]
    cell.traffic = dict(cell.traffic, train_images=4 * batch,
                        test_images=1000)
    return cell


def _run(cell, seed=2 ** 31 + 7):
    res = session.run(cell, seed, 0.5, False,
                      session.Clock(time.perf_counter()),
                      device_name="cpu", log=lambda m: None)
    return run.result_line(cell, res, False, {"platform": "cpu"}), res


def test_a_tiny_cell_prints_a_line_of_the_contracts_shape():
    cell = tiny_cell("cnn-b256")
    line, res = _run(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"train_images_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == set(cell.limits)
    assert res["images"] == res["epochs"] * 4 * 256
    json.dumps(line)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "eval_altered"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    cell = tiny_cell("cnn-b256")
    if fault == "state_unchanged":
        from pytorch_distributed_mnist_tpu_torch.ops.adam import FusedAdam

        monkeypatch.setattr(FusedAdam, "step", lambda self, closure=None:
                            None)
    with control.planted(None if fault == "state_unchanged" else fault):
        line, _ = _run(cell)
    assert line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("name, seed", [("cnn-b256", 2 ** 31 + 3),
                                        ("cnn-b256", 17),
                                        ("vit-t49-b256", 2 ** 31 + 3),
                                        ("vit-t196-b256", 2 ** 31 + 3)])
def test_the_control_fails_a_number(name, seed):
    cell = tiny_cell(name)
    ref = spec.load_module("reference", cell.model)
    cpu = torch.device("cpu")
    prog, rank = control.probe(cell, seed, cpu, ref)
    numbers, against = session.reference_numbers(cell, rank, prog, cpu)
    # the probe's numbers; the optimizer's count is a window's
    limits = {k: v for k, v in cell.limits.items()
              if k != "optimizer_steps_gap"}
    assert check.failing(numbers, limits) == []
    fp8 = check.reference_readings(
        ref, cell.config, cell.traffic, rank.weights,
        rank.probe_batches(cpu), torch.from_numpy(rank.host["test_image"]),
        torch.from_numpy(rank.host["test_label"]), "fp8")
    assert check.failing(check.gaps(fp8, against), limits)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, os.path.join(spec.BENCH_DIR, "run.py"), "--workload",
         "cnn-b256", "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace",
         "0"], capture_output=True, text=True, cwd=spec.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
