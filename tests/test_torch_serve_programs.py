"""The port's serving precision plane (``serve/programs.py``), bitwise
against the JAX functions of the same names."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_mnist_tpu.data.mnist import normalize_images
from pytorch_distributed_mnist_tpu_torch.data import mnist as port_mnist
from pytorch_distributed_mnist_tpu_torch.serve import programs as port

ref = importlib.import_module("pytorch_distributed_mnist_tpu.serve.programs")

pytestmark = pytest.mark.serve

ALL_PIXELS = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def test_act_scale_and_mnist_constants():
    assert port.ACT_SCALE.dtype == np.float32
    assert _bits(port.ACT_SCALE) == _bits(ref.ACT_SCALE)
    assert (port_mnist.MNIST_MEAN, port_mnist.MNIST_STD) == (0.1307, 0.3081)


@pytest.mark.parametrize("scale", [1e-3, 0.05, 1.0, 40.0])
def test_quantize_leaf_i8_bitwise(scale):
    rng = np.random.default_rng(int(scale * 1000))
    for shape in [(3, 3, 1, 32), (12544, 16), (10,)]:
        leaf = (rng.standard_normal(shape) * scale).astype(np.float32)
        got = port.quantize_leaf_i8(leaf)
        want = ref.quantize_leaf_i8(leaf)
        assert got.q.dtype == np.int8 and got.s.dtype == np.float32
        assert _bits(got.q) == _bits(want.q)
        assert _bits(got.s) == _bits(np.float32(want.s))


def test_quantize_leaf_i8_zero_leaf_gets_unit_scale():
    got = port.quantize_leaf_i8(np.zeros((4, 4), np.float32))
    assert got.s == np.float32(1.0) and not got.q.any()


def test_fused_normalize_bitwise_over_all_pixels():
    want = np.asarray(jax.jit(ref.fused_normalize)(jnp.asarray(ALL_PIXELS)))
    got = port.fused_normalize(torch.from_numpy(ALL_PIXELS))
    assert got.dtype == torch.float32 and got.shape == (1, 16, 16, 1)
    assert _bits(got.numpy()) == _bits(want)
    assert _bits(got.numpy()) == _bits(normalize_images(ALL_PIXELS))
    assert _bits(port_mnist.normalize_images(ALL_PIXELS)) == _bits(want)


def test_quant_i8_traced_bitwise_over_all_pixels():
    x = normalize_images(ALL_PIXELS)
    want = np.asarray(jax.jit(ref.quant_i8_traced)(jnp.asarray(x)))
    got = port.quant_i8_traced(torch.from_numpy(x))
    assert got.dtype == torch.int8
    assert _bits(got.numpy()) == _bits(want)
    # ... and equal to the host quantizer the split plane stages with.
    assert _bits(port._quant_i8_host(x, port.ACT_SCALE)) == _bits(want)


def test_dequantize_params_bitwise():
    rng = np.random.default_rng(7)
    leaves = {"w": (rng.standard_normal((64, 10)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal((10,)) * 0.01).astype(np.float32)}
    jtree = {k: ref.quantize_leaf_i8(v) for k, v in leaves.items()}
    jtree["step"] = np.int32(3)
    want = jax.jit(ref.dequantize_params)(jtree)
    ttree = {k: port.QuantLeaf(q=torch.from_numpy(v.q),
                               s=torch.tensor(float(v.s)))
             for k, v in jtree.items() if k != "step"}
    ttree["step"] = torch.tensor(3, dtype=torch.int32)
    got = port.dequantize_params(ttree)
    for k in leaves:
        assert _bits(got[k].numpy()) == _bits(want[k])
    assert int(got["step"]) == 3


def test_precision_registry_and_names():
    assert port.serve_precisions() == ref.serve_precisions()
    assert port.serve_modes() == ref.serve_modes() == [
        "replicated", "expert", "pipeline", "tensor"]
    for name in (None, "f32", "bf16", "int8"):
        assert port.precision_engine_name(None, name) == \
            ref.precision_engine_name(None, name)
        assert port.precision_engine_name("cnn", name) == \
            ref.precision_engine_name("cnn", name)
    with pytest.raises(ValueError, match="unknown serve precision"):
        port.get_precision("fp4")
    assert port.get_precision("int8").input_dtype == torch.int8
    assert port.get_precision(None).identity


def test_int8_quantize_is_idempotent_and_skips_integer_leaves():
    spec = port.get_precision("int8")
    params = {"w": np.ones((3, 3), np.float32),
              "n": np.arange(3, dtype=np.int32)}
    once = spec.quantize(params)
    assert isinstance(once["w"], port.QuantLeaf)
    assert once["n"] is params["n"]
    twice = spec.quantize(once)
    assert twice["w"] is once["w"]


def test_checkpoint_layout_gate():
    port.check_checkpoint_layout(None, "replicated", "cnn")
    port.check_checkpoint_layout({"tensor": 1}, "replicated", "cnn")
    with pytest.raises(ValueError, match="tensor-parallel"):
        port.check_checkpoint_layout({"tensor": 2}, "replicated", "cnn")
