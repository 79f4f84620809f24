"""The port imports ``torch``, numpy and the standard library only: never
JAX, flax or optax, and nothing of the JAX package, whose name is a prefix
of the port's (so every check matches whole module names)."""

import json
import pkgutil
import subprocess
import sys

import pytest

import pytorch_distributed_mnist_tpu_torch as port

pytestmark = pytest.mark.serve

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
              "pytorch_distributed_mnist_tpu")

_PROBE = """
import importlib, json, pkgutil, sys
import pytorch_distributed_mnist_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
forbidden = {forbidden!r}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in forbidden)
print(json.dumps([len(names), bad]))
"""


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, port.__name__ + "."))


def test_every_module_imports_without_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=_FORBIDDEN)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad = json.loads(proc.stdout.strip().splitlines()[-1])
    assert count == len(_modules()) >= 48
    assert bad == [], f"the port pulled in {bad}"


def test_the_ported_modules_keep_their_counterparts_paths():
    names = set(_modules())
    for rel in ("models.registry", "models.linear", "models.cnn",
                "models.attention", "ops.attention", "ops.flash",
                "ops.matmul_i8", "ops.xent", "ops.adam", "ops.loss",
                "ops.metrics", "data.mnist", "data.sampler", "data.loader",
                "train.checkpoint", "train.state", "train.steps",
                "train.trainer", "train.lr_schedule", "utils.profiling",
                "utils.logging", "serve.programs", "serve.engine",
                "serve.control", "serve.economics", "serve.batcher",
                "serve.reload", "serve.server", "serve.pool",
                "serve.canary", "serve.router", "parallel.distributed",
                "parallel.launcher", "parallel.collectives", "parallel.mesh",
                "distrib.cas", "distrib.publish", "distrib.fetch",
                "data.native", "data.download", "utils.watchdog",
                "utils.compile_cache", "runtime.supervision",
                "runtime.elastic", "runtime.chaos", "cli", "__main__",
                "models.moe", "parallel.moe_dispatch", "parallel.expert",
                "parallel.tensor", "parallel.zero", "parallel.zero_overlap",
                "parallel.ring", "parallel.ulysses", "parallel.pipeline_tp",
                "parallel.pipeline", "parallel.pipeline_vit",
                "parallel.split_tree"):
        assert f"{port.__name__}.{rel}" in names, rel
