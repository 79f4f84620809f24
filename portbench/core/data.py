"""The benchmark's inputs, made from ``--seed``: the MNIST-shaped images and
labels, the order the batches take them in, and the initial weights.

The images are a frozen, vectorised copy of the port's synthetic
generator (``data/mnist.py::synthetic_dataset``): a 5x7 digit glyph
scaled 3x, placed at a random offset, at a random intensity, with
Gaussian noise, clipped to uint8, then normalised as the loader holds
them (``(x / 255 - 0.1307) / 0.3081``, float32, NHWC). It runs on the
device in a few large calls; only its result is handed to the port.

The batch order is a copy of the sampler's arithmetic for one rank
(``default_rng(seed + epoch).permutation``): the reference works the rows
out again here instead of asking the port which rows it took.

The weights come from one ``torch.Generator`` on the device: one normal
draw for every leaf at once, cut into leaves and scaled (LeCun normal for
kernels, 0.02 for ``pos_embed``), zeros for biases and ones for
LayerNorm scales.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

MNIST_MEAN = 0.1307
MNIST_STD = 0.3081
SEED_MOD = 2 ** 62  # every generator takes the seed modulo this

_GLYPHS = [
    "01110 10001 10011 10101 11001 10001 01110",
    "00100 01100 00100 00100 00100 00100 01110",
    "01110 10001 00001 00010 00100 01000 11111",
    "11111 00010 00100 00010 00001 10001 01110",
    "00010 00110 01010 10010 11111 00010 00010",
    "11111 10000 11110 00001 00001 10001 01110",
    "00110 01000 10000 11110 10001 10001 01110",
    "11111 00001 00010 00100 01000 01000 01000",
    "01110 10001 10001 01110 10001 10001 01110",
    "01110 10001 10001 01111 00001 00010 01100",
]


def _glyphs(device) -> torch.Tensor:
    """(10, 21, 15) float32: each 5x7 glyph scaled 3x."""
    g = torch.tensor([[[int(c) for c in row] for row in glyph.split()]
                      for glyph in _GLYPHS], dtype=torch.float32)
    return g.repeat_interleave(3, 1).repeat_interleave(3, 2).to(device)


def images_and_labels(n: int, seed: int, device) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` normalised images ``(n, 28, 28, 1)`` float32 and their int64
    labels, on ``device``, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed % SEED_MOD)
    labels = torch.randint(0, 10, (n,), generator=gen, device=device)
    glyphs = _glyphs(device)
    gh, gw = glyphs.shape[1:]
    rows = torch.randint(0, 28 - gh + 1, (n,), generator=gen, device=device)
    cols = torch.randint(0, 28 - gw + 1, (n,), generator=gen, device=device)
    intensity = 0.6 + 0.4 * torch.rand(n, generator=gen, device=device)
    canvas = 12.0 * torch.randn((n, 28, 28), generator=gen, device=device)
    ar = torch.arange(n, device=device)[:, None, None]
    r = rows[:, None, None] + torch.arange(gh, device=device)[None, :, None]
    c = cols[:, None, None] + torch.arange(gw, device=device)[None, None, :]
    canvas[ar, r, c] += glyphs[labels] * (255.0 * intensity)[:, None, None]
    pixels = canvas.clamp_(0.0, 255.0).floor_()
    images = (pixels / 255.0 - MNIST_MEAN) / MNIST_STD
    return images[..., None].contiguous(), labels


def dataset(traffic: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The cell's train and test sets, drawn from disjoint seeds."""
    train_x, train_y = images_and_labels(traffic["train_images"], seed,
                                         device)
    test_x, test_y = images_and_labels(traffic["test_images"],
                                       seed + 1_000_003, device)
    return {"train_image": train_x, "train_label": train_y,
            "test_image": test_x, "test_label": test_y}


def batch_rows(n: int, seed: int, epoch: int, step: int, batch: int) \
        -> np.ndarray:
    """The row indices of train batch ``step`` of ``epoch``: the sampler's
    permutation from ``default_rng(seed + epoch)``, ``batch`` at a time."""
    order = np.random.default_rng(seed + epoch).permutation(n)
    return order[step * batch: (step + 1) * batch]


def make_weights(leaves, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial weights from ``leaves`` (``(name, shape, init)``, the
    reference's list): float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed((seed + 7) % SEED_MOD)
    sizes = [int(np.prod(shape)) for _, shape, _ in leaves]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, init), size in zip(leaves, sizes):
        part = draw[at: at + size].view(shape)
        at += size
        kind, _, arg = init.partition(":")
        if kind == "lecun":
            out[name] = part * (1.0 / float(arg)) ** 0.5
        elif kind == "normal":
            out[name] = part * float(arg)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"leaf {name}: unknown init {init!r}")
    return out
