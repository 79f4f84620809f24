"""The benchmark's FLOP and byte counts against values worked by hand."""

import json
import os

import pytest

from portbench.core import spec

CONFIGS = os.path.join(spec.BENCH_DIR, "configs")


def _config(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def test_cnn_forward_is_32_6_mflop_an_image():
    # conv1: 28*28 outputs x 32 channels x 3*3*1 taps; conv2: 28*28 x 64 x
    # 3*3*32 (padding 1 keeps 28x28); fc1 12544x128; fc2 128x10; two FLOPs
    # a multiply-add.
    hand = 2 * (784 * 32 * 9 + 784 * 64 * 288 + 12544 * 128 + 128 * 10)
    counts = spec.load_module("counts", "cnn")
    assert hand == 32_566_784
    assert counts.forward_flops(_config("cnn"), {}) == hand


@pytest.mark.parametrize("patch, tokens, hand", [
    # embed 49x16x64; per block qkv 49x64x192, q k^T and p v 2 x 4 heads x
    # 49x49x16, proj 49x64x64, mlp 2 x 49x64x256; two blocks; head 64x10.
    (4, 49, 2 * (49 * 16 * 64 + 2 * (49 * 64 * 192 + 2 * 4 * 49 * 49 * 16
                                    + 49 * 64 * 64 + 2 * 49 * 64 * 256)
                 + 64 * 10)),
    (2, 196, 2 * (196 * 4 * 64 + 2 * (196 * 64 * 192
                                      + 2 * 4 * 196 * 196 * 16
                                      + 196 * 64 * 64 + 2 * 196 * 64 * 256)
                  + 64 * 10)),
])
def test_vit_forward_flops(patch, tokens, hand):
    counts = spec.load_module("counts", "vit")
    traffic = {"patch_size": patch}
    assert counts.tokens(_config("vit"), traffic) == tokens
    assert counts.forward_flops(_config("vit"), traffic) == hand


def test_vit_forward_is_11_0_and_58_3_mflop():
    counts = spec.load_module("counts", "vit")
    assert counts.forward_flops(_config("vit"), {"patch_size": 4}) \
        == 10_964_736
    assert counts.forward_flops(_config("vit"), {"patch_size": 2}) \
        == 58_305_792


def test_kernel_bytes():
    xent = spec.load_module("counts", "xent")
    adam = spec.load_module("counts", "adam")
    flash = spec.load_module("counts", "flash")
    # logits f32, labels int64, loss and lse f32
    assert xent.fwd_bytes(256, 10) == 256 * 10 * 4 + 256 * 8 + 2 * 256 * 4
    # logits and dlogits f32, labels int64, lse and g f32
    assert xent.bwd_bytes(256, 10) == 2 * 256 * 10 * 4 + 256 * 8 + 2 * 256 * 4
    assert adam.step_bytes(1_625_866) == 45_524_248
    # q, k, v, o bf16 and lse f32 at (256, 49, 4, 16): PERF.md's bound
    # 0.001977 ms at 3.35 TB/s
    assert flash.fwd_bytes(256, 49, 4, 16) == 4 * 802_816 * 2 + 200_704
    assert flash.fwd_bytes(256, 49, 4, 16) / 3.35e12 * 1e3 == \
        pytest.approx(0.001977, abs=1e-6)
    assert flash.bwd_bytes(256, 49, 4, 16) / 3.35e12 * 1e3 == \
        pytest.approx(0.003894, abs=1e-6)
    assert flash.fwd_flops(256, 49, 4, 16) == 4 * 256 * 4 * 49 * 49 * 16
    assert flash.bwd_flops(256, 49, 4, 16) == \
        10 * 256 * 4 * 49 * 49 * 16


def test_cnn_parameter_count_matches_its_leaves():
    ref = spec.load_module("reference", "cnn")
    cfg = _config("cnn")
    total = 0
    for _name, shape, _init in ref.leaves(cfg, {}):
        n = 1
        for d in shape:
            n *= d
        total += n
    assert total == cfg["parameters"] == 1_625_866
