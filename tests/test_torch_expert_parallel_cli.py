"""``--expert-parallel`` and ``--moe-aux-weight`` through the port's CLI,
on the CPU: twins of the 12 cases of
``tests/test_expert_parallel_cli.py``.

A world of processes runs as ``--spawn N --device cpu`` (gloo), rank 0
writing the epoch rows into ``--metrics-file``; a one-process run goes
through ``cli.run``. EP is a layout change, not a math change: the EP
run's trajectory equals the one-process run's (dense dispatch is
layout-exact; the router is float32). The refusals carry the JAX CLI's
words. The pipeline and two-tier flags (``--pipeline-stages`` and the
rest) wait for ROADMAP Queue 1 item 16 parts 5-6: the port's parser does
not take them.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

from pytorch_distributed_mnist_tpu_torch import cli
from pytorch_distributed_mnist_tpu_torch.models import get_model
from pytorch_distributed_mnist_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_mnist_tpu_torch.train.steps import train_step

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 180  # seconds one spawned world may take


def _base(tmp_path, *extra):
    return ["--dataset", "synthetic", "--model", "moe_mlp", "--epochs", "1",
            "--batch-size", "64", "--synthetic-train-size", "256",
            "--synthetic-test-size", "128", "--seed", "0", "--device", "cpu",
            "--root", str(tmp_path / "data"), *extra]


def _one(tmp_path, name, *extra):
    return cli.run(cli.build_parser().parse_args(_base(
        tmp_path, "--checkpoint-dir", str(tmp_path / name), *extra)))


def _world(tmp_path, name, n, *extra):
    """The epoch rows of a spawned world of ``n`` gloo ranks."""
    rows = tmp_path / f"{name}.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_mnist_tpu_torch",
         "--spawn", str(n), *_base(tmp_path), "--checkpoint-dir",
         str(tmp_path / name), "--metrics-file", str(rows), *extra],
        capture_output=True, text=True, timeout=WORLD_TIMEOUT, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return [json.loads(line) for line in rows.read_text().splitlines()
            if '"train_loss"' in line]


def test_cli_expert_parallel_matches_dp(tmp_path):
    ep = _world(tmp_path, "ep", 4, "--expert-parallel", "4")
    dp = _one(tmp_path, "dp")["history"]
    assert ep[0]["train_loss"] == pytest.approx(dp[0]["train_loss"],
                                                rel=1e-4)
    assert ep[0]["test_acc"] == pytest.approx(dp[0]["test_acc"], abs=1e-6)


def test_cli_expert_parallel_capacity_dispatch(tmp_path):
    """EP x capacity dispatch end to end; with the default capacity factor
    few tokens drop, so the trajectory stays near dense dispatch."""
    cap = _world(tmp_path, "cap", 2, "--expert-parallel", "2",
                 "--moe-dispatch", "capacity")
    dense = _world(tmp_path, "dense", 2, "--expert-parallel", "2")
    assert np.isfinite(cap[0]["train_loss"])
    assert cap[0]["train_loss"] == pytest.approx(dense[0]["train_loss"],
                                                 rel=0.05)


def test_cli_expert_parallel_composes_with_zero1(tmp_path):
    rows = _world(tmp_path, "z1", 2, "--expert-parallel", "2",
                  "--optimizer-sharding", "zero1")
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])


def test_cli_expert_parallel_composes_with_grad_accum_and_fused_loss(
        tmp_path):
    combo = _world(tmp_path, "combo", 2, "--expert-parallel", "2",
                   "--grad-accum", "2", "--loss", "fused")
    plain = _one(tmp_path, "plain")["history"]
    assert combo[0]["train_loss"] == pytest.approx(plain[0]["train_loss"],
                                                   rel=1e-4)
    assert combo[0]["test_acc"] == pytest.approx(plain[0]["test_acc"],
                                                 abs=1e-6)


def test_aux_weight_gradient_flows_metrics_stay_ce():
    """--moe-aux-weight changes the OBJECTIVE (the router gets the
    load-balance gradient) but not the REPORTED loss."""
    rng = np.random.default_rng(5)
    batch = {"image": torch.from_numpy(
                 rng.normal(size=(16, 28, 28, 1)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 10, size=(16,)))}
    s0 = create_train_state(get_model("moe_mlp"), 0, CPU)
    sw = create_train_state(get_model("moe_mlp"), 0, CPU)
    m0 = train_step(s0, batch)
    mw = train_step(sw, batch, aux_weight=0.1)
    assert float(m0.loss_sum) == pytest.approx(float(mw.loss_sum), rel=1e-6)
    r0 = s0.model.moe.router.kernel.detach().numpy()
    rw = sw.model.moe.router.kernel.detach().numpy()
    assert not np.allclose(r0, rw, atol=1e-9)
    # The head has no aux path: from identical moments the first step
    # moves it identically.
    np.testing.assert_allclose(s0.model.head.kernel.detach().numpy(),
                               sw.model.head.kernel.detach().numpy(),
                               atol=1e-6)


def test_aux_weight_rejects_non_aux_intermediates():
    class Sneaky(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(784, 10)

        def forward(self, x, intermediates=False):
            y = self.fc(x.reshape(x.shape[0], -1))
            return (y, {("expert_load",): y.mean()}) if intermediates else y

    from pytorch_distributed_mnist_tpu_torch.train.steps import (
        _forward_with_aux,
    )

    with pytest.raises(ValueError, match="non-aux_loss intermediate"):
        _forward_with_aux(Sneaky(), torch.zeros(8, 28, 28, 1), 0.1)


def test_cli_moe_aux_weight_end_to_end(tmp_path):
    rows = _world(tmp_path, "aux", 2, "--expert-parallel", "2",
                  "--moe-aux-weight", "0.01", "--grad-accum", "2")
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])


def _refused(tmp_path, *extra) -> str:
    with pytest.raises(SystemExit) as info:
        cli.run(cli.build_parser().parse_args(_base(
            tmp_path, "--checkpoint-dir", str(tmp_path / "ckpt"), *extra)))
    return str(info.value)


def test_cli_moe_aux_weight_rejects_non_moe(tmp_path):
    assert _refused(tmp_path, "--moe-aux-weight", "0.01", "--model",
                    "cnn") == ("--moe-aux-weight applies to --model moe_mlp "
                               "(the router sows the load-balance loss); "
                               "got --model cnn")


def test_cli_expert_parallel_rejects_non_moe(tmp_path):
    assert "requires --model moe_mlp" in _refused(
        tmp_path, "--expert-parallel", "2", "--model", "cnn")


def test_cli_expert_parallel_rejects_vit_family_combos(tmp_path, capsys):
    """The JAX CLI refuses EP with TP/SP/PP, in its words."""
    for flag in ("--tensor-parallel", "--sequence-parallel",
                 "--pipeline-stages"):
        assert _refused(tmp_path, "--expert-parallel", "2", flag, "2") == (
            "--expert-parallel does not combine with "
            "--tensor-parallel/--sequence-parallel/--pipeline-stages: "
            "EP shards the moe_mlp expert dim over a data x expert "
            "mesh; the others shard the ViT")


def test_cli_rule_table_parallelism_rejects_zero3(tmp_path):
    """On the JAX test's 8 devices, before any world is made (the flag
    check takes the world's device count)."""
    args = cli.build_parser().parse_args(_base(
        tmp_path, "--optimizer-sharding", "zero3", "--expert-parallel", "2"))
    with pytest.raises(SystemExit, match="zero3 composes with data"):
        cli._check_parallel_flags(args, 8)


def test_cli_expert_parallel_rejects_indivisible_experts(tmp_path):
    assert _refused(tmp_path, "--expert-parallel", "3") == (
        "--expert-parallel 3 must divide the moe_mlp's 8 experts")


def test_cli_expert_parallel_rejects_an_indivisible_world(tmp_path):
    assert _refused(tmp_path, "--expert-parallel", "2") == (
        "--expert-parallel 2 does not divide the 1 available devices")


def _train_flags(parser) -> set:
    return {opt for action in parser._actions for opt in action.option_strings
            if opt.startswith("--")}


def test_the_train_parser_lacks_exactly_the_unported_flags():
    """Beside the JAX CLI's train parser, the port's lacks the flags of the
    two-tier meshes only, and offers ``--model moe_mlp``; the tensor-,
    sequence- and pipeline-parallel flags have the JAX defaults and
    choices."""
    from pytorch_distributed_mnist_tpu.cli import (
        build_parser as jax_build_parser,
    )

    missing = _train_flags(jax_build_parser()) - _train_flags(
        cli.build_parser())
    assert missing == {"--dcn-slices", "--zero-bucket-mb-dcn"}
    model = next(a for a in cli.build_parser()._actions
                 if "--model" in a.option_strings)
    assert "moe_mlp" in model.choices
    args = cli.build_parser().parse_args([])
    jargs = jax_build_parser().parse_args([])
    for flag in ("expert_parallel", "moe_aux_weight", "moe_dispatch",
                 "optimizer_sharding", "zero_overlap", "zero_bucket_mb",
                 "tensor_parallel", "tp_overlap", "sequence_parallel",
                 "sequence_parallel_impl", "pipeline_stages"):
        assert getattr(args, flag) == getattr(jargs, flag), flag
    impl = {a.dest: a.choices for a in cli.build_parser()._actions}
    jimpl = {a.dest: a.choices for a in jax_build_parser()._actions}
    assert impl["sequence_parallel_impl"] == jimpl["sequence_parallel_impl"]
