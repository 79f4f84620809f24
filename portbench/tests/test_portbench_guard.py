"""The guard against JAX and the JAX package, and what the benchmark's
own files import."""

import ast
import glob
import os
import sys

from portbench.core import guard, spec


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_port_passes_and_the_jax_package_fails():
    assert guard.forbidden_modules([
        "pytorch_distributed_mnist_tpu_torch",
        "pytorch_distributed_mnist_tpu_torch.train.trainer", "numpy",
        "jaxtyping", "flaxen"]) == []
    found = ["pytorch_distributed_mnist_tpu", "pytorch_distributed_mnist_tpu.cli",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]
    assert guard.forbidden_modules(found) == sorted(found)


def test_the_guard_reads_the_loaded_modules(monkeypatch):
    assert "jax" not in guard.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax", object())
    assert guard.loaded_forbidden() == ["jax"]


def test_the_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(spec.BENCH_DIR, "reference", "*.py")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("__future__", "torch", "typing", "math"), \
                (path, name)


def test_the_benchmark_reads_nothing_of_the_jax_side_or_the_old_benches():
    banned = set(guard.FORBIDDEN) | {"bench", "tools", "chip_smoke"}
    paths = glob.glob(os.path.join(spec.BENCH_DIR, "**", "*.py"),
                      recursive=True)
    assert len(paths) > 20
    for path in paths:
        for name in _imports(path):
            assert name.split(".")[0] not in banned, (path, name)
