"""``--debug-nans`` (``utils/debug_nans.py``) and ``--profile-dir``
(``utils/profiling.py``) of the port's CLI, on the CPU. The reference's
``jax_debug_nans`` raises ``FloatingPointError`` at the primitive that
made a NaN (``tests/test_integration.py``); here a healthy run prints the
lines of a run without the flag in every trainer mode, a run resumed from
a checkpoint with a NaN weight raises ``FloatingPointError`` naming the
aten op in every mode (scan after re-running the pass eagerly), the
backward pass is checked too, the switch is off after the run, and
``--profile-dir`` writes a trace holding the phase spans."""

import json
import os

import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.train import checkpoint as port_ckpt
from pytorch_distributed_mnist_tpu_torch.utils import debug_nans
from pytorch_distributed_mnist_tpu_torch.utils.profiling import trace_path

pytestmark = pytest.mark.serve
torch.set_num_threads(2)

MODES = ["scan", "stepwise", "explicit"]
_CLI = ["--dataset", "synthetic", "--model", "linear", "--device", "cpu",
        "--synthetic-train-size", "256", "--synthetic-test-size", "128",
        "--batch-size", "64", "--epochs", "2", "--seed", "0",
        "--loss", "fused", "--optimizer", "adam_pallas"]


def _lines(capsys) -> list:
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("Epoch: ")]


def _run(flags):
    return cli.run(cli.build_parser().parse_args(_CLI + flags))


@pytest.mark.parametrize("mode", MODES)
def test_a_healthy_run_prints_the_lines_of_a_run_without_the_flag(
        tmp_path, capsys, mode):
    _run(["--trainer-mode", mode, "--checkpoint-dir", str(tmp_path / "a")])
    want = _lines(capsys)
    _run(["--trainer-mode", mode, "--checkpoint-dir", str(tmp_path / "b"),
          "--debug-nans"])
    assert _lines(capsys) == want and len(want) == 2
    assert not debug_nans.enabled()  # off once the run is over


@pytest.mark.parametrize("mode", MODES)
def test_a_nan_weight_raises_naming_the_op(tmp_path, mode):
    _run(["--trainer-mode", mode, "--checkpoint-dir", str(tmp_path / "a"),
          "--epochs", "1"])
    meta, leaves = port_ckpt.read_checkpoint_arrays(
        str(tmp_path / "a" / "checkpoint_0.npz"))
    name = "['params']['params']['fc']['kernel']"
    leaves[name] = leaves[name].copy()
    leaves[name][3, 4] = np.nan
    bad = port_ckpt._write_npz(list(leaves.items()), epoch=0, best_acc=0.0,
                               directory=str(tmp_path / "bad"))
    with pytest.raises(FloatingPointError,
                       match=r"--debug-nans: aten\.\S+ produced a NaN"):
        _run(["--trainer-mode", mode, "--checkpoint-dir",
              str(tmp_path / "b"), "--resume", bad, "--debug-nans"])
    assert not debug_nans.enabled()
    # Without the flag the same run trains on, NaN and all.
    got = _run(["--trainer-mode", mode, "--checkpoint-dir",
                str(tmp_path / "c"), "--resume", bad])
    assert np.isnan(got["history"][-1]["train_loss"])


def test_the_mode_checks_the_backward_pass_and_skips_allocations():
    x = torch.zeros(3, requires_grad=True)
    with debug_nans.NanCheckMode():
        y = (torch.sqrt(x) * 0.0).sum()  # finite: sqrt(0) = 0
        torch.empty(1 << 16)  # whatever bytes it holds, never checked
        with pytest.raises(FloatingPointError, match="aten.div"):
            y.backward()  # sqrt's gradient: 0 / (2 sqrt(0)) = NaN
    with debug_nans.NanCheckMode():
        torch.full((2,), float("-inf"))  # an Inf is not a NaN


def test_the_kernels_own_checks_run_only_under_the_mode():
    nan = torch.tensor([float("nan")])
    debug_nans.check_outputs("xent_fwd", nan)  # switch off: nothing
    with debug_nans.enabled_for(True):
        debug_nans.check_outputs("xent_fwd", nan)  # no mode: nothing
        with debug_nans.NanCheckMode():
            with pytest.raises(FloatingPointError,
                               match="the xent_fwd kernel produced a NaN"):
                debug_nans.check_outputs("xent_fwd", nan)
    assert not debug_nans.enabled()


def test_profile_dir_writes_a_trace_with_the_phase_spans(tmp_path):
    _run(["--checkpoint-dir", str(tmp_path / "run"), "--profile-dir",
          str(tmp_path / "trace"), "--async-checkpoint"])
    path = trace_path(str(tmp_path / "trace"), 0)
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for evt in events:
        if evt.get("cat") == "user_annotation":
            spans[evt["name"]] = spans.get(evt["name"], 0) + 1
    assert spans["train"] == spans["eval"] == 2
    assert spans["checkpoint_drain"] == 2
    _run(["--checkpoint-dir", str(tmp_path / "run2"), "--profile-dir",
          str(tmp_path / "trace2"), "--epochs", "1"])
    with open(trace_path(str(tmp_path / "trace2"), 0)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"train", "eval", "checkpoint"} <= names
