"""The vit configuration's plain reference: its forward pass in float32
torch operations, with no kernel, graph or batching of the port.

The layers follow ``configs/vit.json`` and the cell's ``patch_size``:
non-overlapping ``p x p`` patches in row-major order, a Dense embedding
plus a learned position embedding, ``depth`` pre-LN blocks (LayerNorm,
multi-head self-attention ``softmax(q k^T / sqrt(d)) v`` with one
``(in, 3 * embed)`` projection split as (3, heads, head_dim), the output
projection, residual; LayerNorm, a Dense of ``mlp_hidden``, the tanh
GELU, a Dense back, residual), a final LayerNorm, the mean over the
tokens and a Dense head. LayerNorm takes ``ln_eps``. ``cast`` is applied
to both operands of every product, the attention's included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def leaves(config: dict, traffic: dict):
    """``(name, shape, init)`` of every weight, in the port's names."""
    p = traffic["patch_size"]
    e, hid = config["embed_dim"], config["mlp_hidden"]
    tokens = (config["image_side"] // p) ** 2
    pp = p * p * config["in_channels"]
    out = [("embed.kernel", (pp, e), f"lecun:{pp}"),
           ("embed.bias", (e,), "zeros"),
           ("pos_embed", (1, tokens, e), "normal:0.02")]
    for i in range(config["depth"]):
        b = f"block{i}"
        out += [(f"{b}.ln1.weight", (e,), "ones"),
                (f"{b}.ln1.bias", (e,), "zeros"),
                (f"{b}.attn.qkv.kernel", (e, 3 * e), f"lecun:{e}"),
                (f"{b}.attn.qkv.bias", (3 * e,), "zeros"),
                (f"{b}.attn.proj.kernel", (e, e), f"lecun:{e}"),
                (f"{b}.attn.proj.bias", (e,), "zeros"),
                (f"{b}.ln2.weight", (e,), "ones"),
                (f"{b}.ln2.bias", (e,), "zeros"),
                (f"{b}.mlp1.kernel", (e, hid), f"lecun:{e}"),
                (f"{b}.mlp1.bias", (hid,), "zeros"),
                (f"{b}.mlp2.kernel", (hid, e), f"lecun:{hid}"),
                (f"{b}.mlp2.bias", (e,), "zeros")]
    out += [("ln_f.weight", (e,), "ones"), ("ln_f.bias", (e,), "zeros"),
            ("head.kernel", (e, config["num_classes"]), f"lecun:{e}"),
            ("head.bias", (config["num_classes"],), "zeros")]
    return out


def _layer_norm(x, params, name, eps):
    return F.layer_norm(x, x.shape[-1:], params[f"{name}.weight"],
                        params[f"{name}.bias"], eps)


def _dense(x, params, name, cast):
    return cast(x) @ cast(params[f"{name}.kernel"]) + params[f"{name}.bias"]


def forward(params: dict, images: torch.Tensor, config: dict, traffic: dict,
            cast=lambda t: t) -> torch.Tensor:
    """float32 logits ``(B, num_classes)`` of ``images`` ``(B, 28, 28, 1)``."""
    p, eps = traffic["patch_size"], config["ln_eps"]
    heads, d = config["num_heads"], config["head_dim"]
    b, side = images.shape[0], config["image_side"]
    g = side // p
    x = images.reshape(b, g, p, g, p, config["in_channels"])
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, -1)
    x = _dense(x, params, "embed", cast) + params["pos_embed"]
    t = x.shape[1]
    for i in range(config["depth"]):
        blk = f"block{i}"
        h = _layer_norm(x, params, f"{blk}.ln1", eps)
        qkv = _dense(h, params, f"{blk}.attn.qkv", cast)
        qkv = qkv.reshape(b, t, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        s = (cast(q) @ cast(k).transpose(-1, -2)) * d ** -0.5
        o = cast(torch.softmax(s, dim=-1)) @ cast(v)
        o = o.permute(0, 2, 1, 3).reshape(b, t, heads * d)
        x = x + _dense(o, params, f"{blk}.attn.proj", cast)
        h = _layer_norm(x, params, f"{blk}.ln2", eps)
        h = F.gelu(_dense(h, params, f"{blk}.mlp1", cast), approximate="tanh")
        x = x + _dense(h, params, f"{blk}.mlp2", cast)
    x = _layer_norm(x, params, "ln_f", eps).mean(dim=1)
    return _dense(x, params, "head", cast)
