"""What decides ``correct``: the program's first steps through its
replayed graphs and an eval pass at the initial weights, read in set-up
through the window's own trainer (``session.Rank.probe``), against the
plain reference worked out again from the same inputs.

The program's readings (:func:`gaps`' ``prog``):

- ``eval_loss``: the mean test loss of ``Trainer.evaluate()`` at the
  initial weights;
- ``losses``: the loss of each probed train step;
- ``counts``: the examples each probed train step and the eval pass
  counted;
- ``grads`` and ``grad_norms``: per leaf, the first step's gradient as
  the optimizer got it, ``mu / (1 - b1)`` from Adam's state after one
  step, and its norm;
- ``changes``: per leaf, the parameters' change over the probed steps.

The reference (:func:`reference_readings`) takes the same weights, the
rows the sampler's arithmetic gives and each step's learning rate, runs
the configuration's plain forward in float32 (TF32 off) with autograd
and plain Adam, and gives the same readings. ``cast`` rounds every
product's operands to a lower precision: that is the control.

Each number is a gap between the two sides' readings (:func:`gaps`):

- ``eval_loss_gap`` and ``loss_gap``: ``|prog - ref| / ref`` of the eval
  pass and of the first step; ``later_loss_gap`` the worst of the later
  steps, read but held to no limit: Adam's first update is near
  ``lr * sign(g)``, so where a gradient element is near 0 its rounding
  flips the update, and the next loss swings from seed to seed at
  every precision (``PERF.md``);
- ``examples_gap``: the share of those examples that went uncounted or
  were counted twice (exact: its limit is 0);
- ``grad_gap`` and ``change_gap``: per leaf ``| |prog| - |ref| |`` over the
  larger of the reference leaf's norm and the median leaf's, the worst
  leaf. ``change_gap`` leaves out the elements whose reference gradient
  is under a thousandth of the median leaf's root-mean-square gradient:
  Adam moves those by round-off alone. The rule is on the reference's
  gradient, element by element, since such an element can share a leaf
  with others (a key's bias under softmax is a third of the ViT's qkv
  bias); a leaf with none left is left out;
- ``grad_diff_least``: per leaf the norm of the two first gradients'
  difference over the same denominator, the least leaf. The program's
  bfloat16 error grows layer by layer back from the loss, so its worst
  leaf is a deep one and reads as high as a coarser rounding of every
  product would (and a gap of norms hardly moves with an error that is
  random from element to element); the least leaf reads the rounding of
  one product, which a lower precision raises on every leaf
  (``PERF.md``). A fault in one leaf is the other numbers' to catch.
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.adam import adam_step

LEAF_FLOOR = 1e-3  # of the median leaf's gradient norm: left out of the change


def _to_fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` as float8 training rounds a tensor: each
    element times the scale that takes the tensor's largest magnitude to
    the format's largest value, rounded, then divided by it again."""
    amax = t.detach().abs().amax().float()
    top = torch.finfo(dtype).max
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8(torch.autograd.Function):
    """float8 training's roundings on a product's operand, each scaled by
    its tensor's largest magnitude: e4m3 forward, and the gradient that
    flows back through it in e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _to_fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2)


def fp8_cast(t: torch.Tensor) -> torch.Tensor:
    """The precision below bfloat16, the control's: ``t`` rounded to
    scaled float8 e4m3, its gradient to scaled e5m2."""
    return _Fp8.apply(t)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


CASTS: Dict[str, Callable] = {"f32": _same, "fp8": fp8_cast}


def _loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels, reduction="sum")


@torch.no_grad()
def _eval_loss(ref, params, images, labels, config, traffic, cast,
               block: int) -> float:
    total = 0.0
    for lo in range(0, images.shape[0], block):
        logits = ref.forward(params, images[lo: lo + block], config, traffic,
                             cast)
        total += float(_loss(logits, labels[lo: lo + block]))
    return total / images.shape[0]


def reference_readings(ref, config: dict, traffic: dict,
                       weights: Dict[str, torch.Tensor],
                       steps: List[dict], test_images: torch.Tensor,
                       test_labels: torch.Tensor, cast: str = "f32",
                       block: int = 1000) -> dict:
    """The reference's readings of the probed steps. ``steps[i]`` holds
    the batch's ``images`` and ``labels`` and the step's ``lr``."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        fn = CASTS[cast]
        params = {k: w.detach().clone().float() for k, w in weights.items()}
        out = {"eval_loss": _eval_loss(ref, params, test_images, test_labels,
                                       config, traffic, fn, block),
               "losses": [], "grad_norms": None, "grads": None,
               "counts": [float(s["labels"].shape[0]) for s in steps]
               + [float(test_images.shape[0])]}
        moments: dict = {}
        for t, step in enumerate(steps, start=1):
            leaves = {k: p.requires_grad_(True) for k, p in params.items()}
            logits = ref.forward(leaves, step["images"], config, traffic, fn)
            total = _loss(logits, step["labels"])
            n = step["labels"].shape[0]
            grads = torch.autograd.grad(total / n, list(leaves.values()))
            grads = dict(zip(leaves, grads))
            out["losses"].append(float(total.detach()) / n)
            if out["grad_norms"] is None:
                out["grad_norms"] = {k: float(g.norm())
                                     for k, g in grads.items()}
                out["grads"] = {k: g.detach().cpu() for k, g in grads.items()}
            params = {k: p.detach() for k, p in params.items()}
            adam_step(params, grads, moments, t, step["lr"], config["b1"],
                      config["b2"], config["eps"])
        out["changes"] = {k: (params[k] - weights[k].float()).cpu()
                          for k in params}
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _per_leaf(prog: Dict[str, float], ref: Dict[str, float]) \
        -> Dict[str, float]:
    """Per leaf of ``ref``, the gap of the two norms over the larger of the
    reference leaf's and the median leaf's."""
    median = statistics.median(ref.values()) if ref else 0.0
    return {k: abs(prog[k] - r) / max(r, median, 1e-30)
            for k, r in ref.items()}


def _worst(per_leaf: Dict[str, float]) -> Optional[float]:
    return max(per_leaf.values(), default=None)


def moved_norms(ref: dict, changes: Dict[str, torch.Tensor]) \
        -> Dict[str, float]:
    """Per leaf, the norm of ``changes`` over the elements whose reference
    gradient is at least :data:`LEAF_FLOOR` of the median leaf's
    root-mean-square gradient; leaves with no such element are left out."""
    floor = LEAF_FLOOR * statistics.median(
        float(g.norm()) / g.numel() ** 0.5 for g in ref["grads"].values())
    out = {}
    for k, g in ref["grads"].items():
        keep = g.abs() >= floor
        if bool(keep.any()):
            out[k] = float(changes[k].float()[keep].norm())
    return out


def _diff_per_leaf(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per leaf of ``ref``, the norm of the difference over the larger of
    the reference leaf's norm and the median leaf's."""
    norms = {k: float(r.norm()) for k, r in ref.items()}
    median = statistics.median(norms.values()) if norms else 0.0
    return {k: float((prog[k].float() - r.float()).norm())
            / max(norms[k], median, 1e-30) for k, r in ref.items()}


def leaf_gaps(prog: dict, ref: dict) -> Dict[str, Dict[str, float]]:
    """Each leaf's gap of the gradient and of the change, and of the
    gradients' difference (for the readings that set the limits: which
    leaf sets the worst)."""
    return {"grad": _per_leaf(prog["grad_norms"], ref["grad_norms"]),
            "change": _per_leaf(moved_norms(ref, prog["changes"]),
                                moved_norms(ref, ref["changes"])),
            "grad_diff": _diff_per_leaf(prog["grads"], ref["grads"])}


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared, from the two sides' readings."""
    per_leaf = leaf_gaps(prog, ref)
    return {
        "eval_loss_gap": abs(prog["eval_loss"] - ref["eval_loss"])
        / ref["eval_loss"],
        "loss_gap": abs(prog["losses"][0] - ref["losses"][0])
        / ref["losses"][0],
        "later_loss_gap": max((abs(p - r) / r for p, r in
                               zip(prog["losses"][1:], ref["losses"][1:])),
                              default=None),
        "grad_gap": _worst(per_leaf["grad"]),
        "examples_gap": sum(abs(p - r) for p, r in
                            zip(prog["counts"], ref["counts"]))
        / sum(ref["counts"]),
        "change_gap": _worst(per_leaf["change"]),
        "grad_diff_least": min(per_leaf["grad_diff"].values(), default=None),
    }


def failing(numbers: Dict[str, float], limits: Dict[str, float]) \
        -> List[str]:
    """The limited numbers over their limit; one with no reading fails."""
    return [k for k, lim in limits.items()
            if numbers.get(k) is None or numbers[k] > lim]
