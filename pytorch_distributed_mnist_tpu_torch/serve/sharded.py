"""The sharded serving forwards: one controller walking a model whose
weights are split over a mesh group's devices.

The JAX package has no module here: its ``serve/programs.py`` lowers the
model's own ``apply`` under ``jax.jit`` with the rule tables' shardings,
and XLA inserts the partial-sum all-reduce. The port writes that forward
out, in one process, one thread: every shard's piece of a split layer
runs on the shard's own device, and the sums that XLA's all-reduce does
are done on the group's lead device (``devices[0]``), in float32 and in
shard order (an int8 product sums exact int32). The layers the rule
table leaves whole (the ends, the LayerNorms, the row-parallel biases)
run once, on the lead. No process group is made.

- :class:`ShardedViT` (``--serve-mode tensor``, ``vit_tp_rules``): per
  block, each shard's column products (``qkv``, ``mlp1``), its heads'
  attention and its row product (``proj``, ``mlp2``); the row partials
  are summed on the lead, the bias added once, and the activation handed
  back to every shard for the next column product
  (``models/attention.py::_row_parallel``'s arithmetic). ``qkv`` is
  split head-aligned (``blocks=3``). When the mesh does not divide the
  heads (the 4-head ViT over 8 devices passes the reference's
  divisibility check, 192 and 64 dividing by 8), a shard holds part of a
  head: the shards' q, k and v columns are then gathered on the lead,
  attention runs there, and each shard takes its columns of the output
  for its rows of ``proj``.
- :class:`ShardedMoE` (``--serve-mode expert``, ``moe_ep_rules``): the
  embed, the router and the head on the lead, each shard's local experts
  on its device; the one-hot combine's sum over experts is the sum of
  the shards' shares on the lead (``models/moe.py``'s dense dispatch).

On the int8 plane a split Dense quantizes with the scales of the WHOLE
input and weight (the max of the shards' peaks), runs one int8 product
per shard (``ops/matmul_i8.py::int8_linear`` with ``peaks=``), and a row
product adds the shards' int32 sums before one rescale: every product
is the unsharded one bit for bit, the kernel's route and the plain
route alike. The int8 products per forward of a tensor group of ``m``
devices are ``2 + 4 * m * depth`` (embed and head once, on the lead).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from pytorch_distributed_mnist_tpu_torch.ops.matmul_i8 import (
    abs_peak,
    rescale_i8,
)

__all__ = ["ShardedMoE", "ShardedViT", "make_sharded_forward"]

Shards = List[Dict[str, torch.Tensor]]


def _peak(pieces: Sequence[torch.Tensor], lead: torch.device):
    """The peak (``abs_peak``) of the whole tensor that ``pieces`` split,
    on the lead device."""
    peaks = [abs_peak(p).to(lead) for p in pieces]
    return torch.stack(peaks).amax() if len(peaks) > 1 else peaks[0]


class _Sharded:
    """What both forwards share: the group's devices and the model's
    compute dtype and Dense contraction."""

    def __init__(self, model, devices: Sequence[torch.device]) -> None:
        self.model = model
        self.devices = list(devices)
        self.lead = self.devices[0]
        self.cd = model.compute_dtype

    def _call(self, module, leaves: Dict[str, torch.Tensor], *args):
        """``module``'s own forward on the given leaves."""
        return torch.func.functional_call(module, leaves, args)

    def _column(self, layer, x: torch.Tensor, shards: Shards, kernel: str,
                bias: str) -> List[torch.Tensor]:
        """A column-parallel Dense: ``x`` (whole, on the lead) on every
        shard's device times that shard's columns, plus its bias
        columns. One output per shard, on the shard's device."""
        cd = layer.compute_dtype
        xs = [x.to(cd).to(dev) for dev in self.devices]
        ws = [s[kernel].to(cd) for s in shards]
        if layer.matmul is None:
            parts = [torch.matmul(xi, w) for xi, w in zip(xs, ws)]
        else:
            pa = abs_peak(xs[0])
            pb = _peak(ws, self.lead)
            parts = [layer.matmul(xi, w, cd, peaks=(pa.to(dev), pb.to(dev)))
                     for xi, w, dev in zip(xs, ws, self.devices)]
        return [p + s[bias].to(cd) for p, s in zip(parts, shards)]

    def _row(self, layer, parts_in: List[torch.Tensor], shards: Shards,
             kernel: str, bias: torch.Tensor) -> torch.Tensor:
        """A row-parallel Dense: each shard's input columns times its
        rows, the partials summed on the lead (float32, or exact int32
        on the int8 plane) in shard order, then the bias once."""
        cd = layer.compute_dtype
        xs = [p.to(cd) for p in parts_in]
        ws = [s[kernel].to(cd) for s in shards]
        if layer.matmul is None:
            total = None
            for xi, w in zip(xs, ws):
                part = torch.matmul(xi, w).float().to(self.lead)
                total = part if total is None else total + part
            out = total.to(cd)
        else:
            pa = _peak(xs, self.lead)
            pb = _peak(ws, self.lead)
            total = None
            for xi, w, dev in zip(xs, ws, self.devices):
                acc = layer.matmul(xi, w, cd, peaks=(pa.to(dev), pb.to(dev)),
                                   raw=True).to(self.lead)
                total = acc if total is None else total + acc
            out = rescale_i8(total, pa, pb).to(cd)
        return out + bias.to(cd)


class ShardedViT(_Sharded):
    """The ViT (``models/attention.py``) over a ``tensor`` mesh group."""

    def __init__(self, model, devices: Sequence[torch.device]) -> None:
        super().__init__(model, devices)
        from pytorch_distributed_mnist_tpu_torch.ops.attention import (
            full_attention,
        )
        from pytorch_distributed_mnist_tpu_torch.parallel.split_tree import (
            _Method,
        )

        if getattr(model, "seq_axis", None) is not None:
            raise ValueError("the tensor serve mode takes a ViT built "
                             "without a mesh")
        self._ends = _Method(model)
        self.attend = model.attention_fn or full_attention
        self.heads = model.num_heads
        self.depth = model.depth
        self.head_dim = model.embed_dim // model.num_heads
        # Whether every shard holds whole heads of qkv (its heads'
        # attention runs on its own device).
        self.whole_heads = model.num_heads % len(self.devices) == 0

    def _leaves(self, shard: Dict[str, torch.Tensor], *names) -> dict:
        return {"model." + n: shard[n] for n in names}

    def _attention(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per shard ``(B, T, 3 * C / m)`` qkv columns (head-aligned: the
        shard's q, then k, then v columns) -> per shard ``(B, T, C / m)``
        attention output columns, on the shard's device."""
        cd, d, m = self.cd, self.head_dim, len(self.devices)
        b, t = parts[0].shape[:2]
        if self.whole_heads:
            outs = []
            for part in parts:
                h = part.shape[-1] // (3 * d)
                qkv = part.reshape(b, t, 3, h, d)
                o = self.attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
                outs.append(o.reshape(b, t, h * d).to(cd))
            return outs
        # Parts of heads: gather q, k and v whole on the lead.
        cols = [p.reshape(b, t, 3, -1).to(self.lead) for p in parts]
        qkv = torch.cat(cols, dim=-1).reshape(b, t, 3, self.heads, d)
        o = self.attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        o = o.reshape(b, t, self.heads * d).to(cd)
        return [piece.to(dev) for piece, dev in
                zip(o.chunk(m, dim=-1), self.devices)]

    def _block(self, i: int, x: torch.Tensor, shards: Shards) -> torch.Tensor:
        from pytorch_distributed_mnist_tpu_torch.models.attention import (
            layer_norm,
        )

        block = getattr(self.model, f"block{i}")
        pre, lead = f"block{i}.", shards[0]
        h = layer_norm(x, lead[pre + "ln1.weight"], lead[pre + "ln1.bias"],
                       self.cd)
        qkv = self._column(block.attn.qkv, h, shards,
                           pre + "attn.qkv.kernel", pre + "attn.qkv.bias")
        o = self._attention(qkv)
        x = x + self._row(block.attn.proj, o, shards,
                          pre + "attn.proj.kernel",
                          lead[pre + "attn.proj.bias"])
        h = layer_norm(x, lead[pre + "ln2.weight"], lead[pre + "ln2.bias"],
                       self.cd)
        y = self._column(block.mlp1, h, shards, pre + "mlp1.kernel",
                         pre + "mlp1.bias")
        y = [F.gelu(part, approximate="tanh") for part in y]
        return x + self._row(block.mlp2, y, shards, pre + "mlp2.kernel",
                             lead[pre + "mlp2.bias"])

    def __call__(self, shards: Shards, images: torch.Tensor) -> torch.Tensor:
        lead = shards[0]
        x = self._call(self._ends, self._leaves(
            lead, "embed.kernel", "embed.bias", "pos_embed"),
            "embed_tokens", images)
        for i in range(self.depth):
            x = self._block(i, x, shards)
        return self._call(self._ends, self._leaves(
            lead, "ln_f.weight", "ln_f.bias", "head.kernel", "head.bias"),
            "pool_logits", x)


class ShardedMoE(_Sharded):
    """``moe_mlp`` (``models/moe.py``, dense dispatch) over an
    ``expert`` mesh group: each shard computes its local experts."""

    def __init__(self, model, devices: Sequence[torch.device]) -> None:
        super().__init__(model, devices)
        if model.moe.dispatch != "dense":
            raise ValueError(f"the expert serve mode runs the dense "
                             f"dispatch, not {model.moe.dispatch!r}")

    def __call__(self, shards: Shards, images: torch.Tensor) -> torch.Tensor:
        from pytorch_distributed_mnist_tpu_torch.parallel.moe_dispatch import (
            top1_mask_gate,
        )

        model, lead, cd = self.model, shards[0], self.cd
        x = images.reshape(images.shape[0], -1).to(cd)
        x = F.relu(self._call(model.embed, {
            "kernel": lead["embed.kernel"], "bias": lead["embed.bias"]}, x))
        probs = torch.softmax(self._call(model.moe.router, {
            "kernel": lead["moe.router.kernel"],
            "bias": lead["moe.router.bias"]}, x.to(torch.float32)), dim=-1)
        mask, gate = top1_mask_gate(probs)
        gate = gate[:, None]
        xc = x.to(cd)
        total, lo = None, 0
        for shard, dev in zip(shards, self.devices):
            e_loc = shard["moe.w1"].shape[0]
            hdn = F.relu(torch.einsum("bc,ech->beh", xc.to(dev),
                                      shard["moe.w1"].to(cd))
                         + shard["moe.b1"].to(cd))
            y = (torch.einsum("beh,ehc->bec", hdn, shard["moe.w2"].to(cd))
                 + shard["moe.b2"].to(cd))
            share = torch.einsum("bec,be->bc", y.to(torch.float32),
                                 mask[:, lo:lo + e_loc].to(dev)) \
                * gate.to(dev)
            share = share.to(self.lead)
            total = share if total is None else total + share
            lo += e_loc
        x = x + total.to(x.dtype)
        return self._call(model.head, {"kernel": lead["head.kernel"],
                                       "bias": lead["head.bias"]},
                          x).float()


_FORWARDS = {"vit": ShardedViT, "moe_mlp": ShardedMoE}


def make_sharded_forward(model_name: str, model, devices):
    """The sharded forward of ``model_name`` over ``devices``:
    ``forward(shards, images) -> float32 logits`` on ``devices[0]``,
    ``shards`` one dict of leaves per device (the replicated leaves in
    the first), as ``serve/programs.py::MeshPlacement.place_params``
    lays them out."""
    try:
        cls = _FORWARDS[model_name]
    except KeyError:
        raise ValueError(f"no sharded serving forward for --model "
                         f"{model_name!r}") from None
    return cls(model, devices)
