"""Forward-program registry: model x serve mode -> how one engine spans
its devices, and the serving precision plane.

Counterpart of ``pytorch_distributed_mnist_tpu/serve/programs.py``. Given
a model name and a serve mode, the registry derives every param leaf's
placement from the SAME rule tables training uses (serving cannot
disagree with training on layout) and hands the engine a
:class:`MeshPlacement`.

Modes (``SERVE_MODES``; extensible through :func:`register_serve_mode`):

- ``replicated`` — one whole model per device, fanned out by the pool
  (``serve/pool.py``). Servable by every model; the default, built with
  no placement.
- ``tensor`` — the Megatron column/row-parallel ViT over a ``model``
  axis (``parallel/tensor.py::vit_tp_rules``).
- ``expert`` — the expert-parallel MoE over an ``expert`` axis
  (``parallel/expert.py::moe_ep_rules``).
- ``pipeline`` — one program per stage device, batches streamed along
  the chain (``serve/pipeline.py``; ``parallel/pipeline_vit.py::
  pipeline_stage_rules``): the mode pipeline-trained checkpoints serve
  under.

Where the reference lowers one ``jax.jit`` over the mesh and XLA inserts
the all-reduce, a sharded engine of the port runs the forward of
``serve/sharded.py`` (no JAX counterpart): one controller, each shard's
piece of a split layer on its own device, the partial sums added on the
group's lead device. Inputs go to the lead and logits come back from it,
so the engine's staging and bucketing stay mode-agnostic. A sharded
engine spans its devices, so the pool partitions them into mesh GROUPS
(:func:`partition_groups`), one engine per group.

Precisions (``--serve-precision``): ``f32`` (identity), ``bf16`` (weights
stored bfloat16; compute follows the model's own dtype), ``int8w``
(weight-only int8: per-leaf symmetric scales, dequantized on the device,
f32 activations) and ``int8`` (``int8w`` plus int8 activations with the
fixed normalize-range scale :data:`ACT_SCALE`; the model built for this
plane also runs its Dense layers through the int8 matmul kernel). On a
sharded plane a :class:`QuantLeaf`'s int8 values split like the f32 leaf
and its scale goes with every piece (:meth:`MeshPlacement.place_params`,
which reads the leaf's type: the reference's ``expand_shardings`` tree of
``NamedSharding`` pairs has no use here); a pipeline quantizes each
stage's slice on its own.

The fused plane (the default) takes the raw staged uint8 bytes:
:func:`fused_normalize` and, on ``int8``, :func:`quant_i8_traced` run on
the device and are bitwise equal to their host twins
(``data/mnist.py::normalize_images`` and :func:`_quant_i8_host`, both
run by the native C++ library over the server's ``-j`` threads and equal
to their NumPy expressions bit for bit, ``data/native.py``). Every
divide that must match the host's IEEE divide divides by a tensor on the
same device: on the card, dividing by a Python number becomes a multiply
by its reciprocal, which can differ in the last bit.
"""

from __future__ import annotations

import functools
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from pytorch_distributed_mnist_tpu_torch.data.mnist import MNIST_MEAN, MNIST_STD
from pytorch_distributed_mnist_tpu_torch.parallel.expert import moe_ep_rules
from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_vit import (
    pipeline_stage_rules,
)
from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
    leaf_spec,
    vit_tp_rules,
)

REPLICATED = "replicated"
F32 = "f32"


class ServeMode:
    """One registered parallel serving mode: the mesh axis it shards over
    and, per model family, the rule table deriving every param leaf's
    :class:`~pytorch_distributed_mnist_tpu_torch.parallel.tensor.P` (the
    SAME table training's placement uses).

    Three optional hooks let a mode whose engine is not the sharded
    ``InferenceEngine`` (the pipeline's chain of per-device stage
    programs, ``serve/pipeline.py``) ride every generic path (the layout
    gate, the divisibility walk, the pool's groups, ``/stats``):

    - ``engine_factory``: builds the group's engine instead of the
      default :class:`MeshPlacement` + ``InferenceEngine`` pair
      (:func:`build_group_engine` routes).
    - ``make_template(model_name) -> ServeTemplate``: the template
      checkpoints restore onto, for modes whose training param layout is
      not the model's own (the pipeline's ``{embed, blocks, head}``).
    - ``staged``: the mode's axis is a pipeline of stages, not a spanning
      shard: the auto in-flight window sizes per device (the pipe needs
      at least S batches to fill) and ``/stats`` reports
      ``pipeline_stages``.
    """

    def __init__(self, name: str, axis: str,
                 rules_by_model: Dict[str, Callable],
                 engine_factory: Optional[Callable] = None,
                 make_template: Optional[Callable] = None,
                 staged: bool = False) -> None:
        self.name = name
        self.axis = axis
        self.rules_by_model = dict(rules_by_model)
        self.engine_factory = engine_factory
        self.make_template = make_template
        self.staged = staged

    def rules_for(self, model_name: str):
        try:
            rules_fn = self.rules_by_model[model_name]
        except KeyError:
            raise ValueError(
                f"--serve-mode {self.name} has no sharding rule table for "
                f"--model {model_name!r} (servable modes for it: "
                f"{servable_modes(model_name)})"
            ) from None
        return rules_fn(self.axis)


_MODES: Dict[str, ServeMode] = {}


def register_serve_mode(name: str, axis: str,
                        rules_by_model: Dict[str, Callable],
                        engine_factory: Optional[Callable] = None,
                        make_template: Optional[Callable] = None,
                        staged: bool = False) -> ServeMode:
    """Register a parallel serving mode (a new rule table becomes
    servable by adding one entry, with no engine, pool or server
    change). See :class:`ServeMode` for the optional hooks."""
    if name == REPLICATED or name in _MODES:
        raise ValueError(f"serve mode {name!r} already registered")
    mode = ServeMode(name, axis, rules_by_model,
                     engine_factory=engine_factory,
                     make_template=make_template, staged=staged)
    _MODES[name] = mode
    return mode


register_serve_mode("tensor", "model", {"vit": vit_tp_rules})
register_serve_mode("expert", "expert", {"moe_mlp": moe_ep_rules})


def serve_modes() -> List[str]:
    """Every registered mode, ``replicated`` first (the default)."""
    return [REPLICATED] + sorted(_MODES)


def get_serve_mode(mode: str) -> ServeMode:
    """The registered :class:`ServeMode` for ``mode`` (raises with the
    registry's vocabulary for unknown names; ``replicated`` has no
    ServeMode object and is refused here too)."""
    return _get_mode(mode)


def staged_mode(mode: str) -> bool:
    """Whether ``mode`` is a registered STAGED (pipeline-of-programs)
    mode; replicated and unknown names are not."""
    spec = _MODES.get(mode)
    return spec is not None and spec.staged


class ServeTemplate(NamedTuple):
    """What a checkpoint restores onto under one serve mode: the model,
    the param names and shapes in the port's layout, and the root of
    their JAX paths (``"['params']"``, the flax variables' level;
    ``""`` for a tree the JAX state holds as its params directly, the
    pipeline's split tree). ``split`` marks the pipeline's tree: fresh
    params are the model's, stacked (:meth:`fresh`)."""

    model_name: str
    shapes: Dict[str, tuple]
    root: str = "['params']"
    split: bool = False

    def fresh(self, seed: int) -> Dict[str, np.ndarray]:
        """Seeded params in this template's layout (the boot's params
        when no checkpoint is published)."""
        from pytorch_distributed_mnist_tpu_torch.models.convert import (
            init_params,
        )

        params = init_params(self.model_name, seed)
        if not self.split:
            return params
        from pytorch_distributed_mnist_tpu_torch.parallel.pipeline_vit import (
            split_vit_params,
        )

        return split_vit_params(params)


def model_template(model_name: str) -> ServeTemplate:
    """The model's own layout: the template of every mode without a
    ``make_template`` hook."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        param_shapes,
    )

    return ServeTemplate(model_name, param_shapes(model_name))


def template_of(template) -> ServeTemplate:
    """A :class:`ServeTemplate`, or a model name (its own layout)."""
    if isinstance(template, ServeTemplate):
        return template
    return model_template(template)


def make_serve_template(mode: str, model_name: str) -> ServeTemplate:
    """The template checkpoints restore onto under ``mode``: the mode's
    ``make_template`` hook (the pipeline's split tree), else the model's
    own layout, as every replicated server has always loaded."""
    if mode != REPLICATED:
        spec = _get_mode(mode)
        if spec.make_template is not None:
            return spec.make_template(model_name)
    return model_template(model_name)


def servable_modes(model_name: str) -> List[str]:
    """The serve modes with a rule table for ``model_name`` (always
    includes ``replicated``): the vocabulary every refusal speaks."""
    return [REPLICATED] + sorted(
        name for name, mode in _MODES.items()
        if model_name in mode.rules_by_model
    )


def _get_mode(mode: str) -> ServeMode:
    try:
        return _MODES[mode]
    except KeyError:
        raise ValueError(
            f"unknown serve mode {mode!r}; registered: {serve_modes()}"
        ) from None


class QuantLeaf(NamedTuple):
    """One int8-quantized param leaf: the int8 values (original shape) and
    the float32 symmetric scale, installed together so a hot reload stays
    one reference swap."""

    q: object  # int8 values, the original leaf's shape
    s: object  # float32 scale (dequant: q.float() * s)


def _act_scale() -> np.float32:
    """The FIXED int8 activation scale: normalized MNIST pixels live in
    ``[(0-mean)/std, (1-mean)/std]`` (max |x| at pixel 255), so one
    symmetric scale covers every request. float32 ops, as the reference
    computes it."""
    max_abs = ((np.float32(1.0) - np.float32(MNIST_MEAN))
               / np.float32(MNIST_STD))
    return np.float32(max_abs / np.float32(127.0))


ACT_SCALE = _act_scale()
_INV_ACT_SCALE = float(np.float32(1.0) / ACT_SCALE)


def _quant_i8_host(x: np.ndarray, scale: np.float32,
                   workers: int = 4) -> np.ndarray:
    """The host-side float32 -> int8 quantizer (weight leaves and the split
    plane's activation staging): multiply by the float32 reciprocal (never
    a division: the two round differently), round half to even, NaN -> 0,
    clip to +-127. The native kernel over ``workers`` threads, else (under
    ``TPUMNIST_NATIVE=0``) the same NumPy expression."""
    from pytorch_distributed_mnist_tpu_torch.data import native

    x = np.ascontiguousarray(x, np.float32)
    q = native.quant_i8(x, float(scale), workers=workers)
    if q is not None:
        return q
    inv = np.float32(1.0) / scale
    scaled = np.rint(x * inv)
    scaled = np.where(np.isnan(scaled), np.float32(0.0), scaled)
    return np.clip(scaled, -127, 127).astype(np.int8)


def quantize_leaf_i8(leaf) -> QuantLeaf:
    """Symmetric per-leaf int8 quantization (host-side, install time):
    ``scale = max|leaf| / 127``, ``q = clip(rne(leaf * (1/scale)), +-127)``.
    An all-zero leaf gets scale 1.0."""
    x = np.ascontiguousarray(np.asarray(leaf), np.float32)
    max_abs = float(np.max(np.abs(x))) if x.size else 0.0
    scale = np.float32(max_abs) / np.float32(127.0) \
        if max_abs > 0.0 else np.float32(1.0)
    return QuantLeaf(q=_quant_i8_host(x, scale), s=scale)


def dequantize_params(tree):
    """Every :class:`QuantLeaf` becomes its float32 leaf (``q.float() *
    s``); everything else passes through. Runs on the device, per forward:
    the weights rest in int8. A sharded engine's params (one dict per
    shard) dequantize shard by shard."""
    if isinstance(tree, list):
        return [dequantize_params(shard) for shard in tree]
    return {name: leaf.q.float() * leaf.s if isinstance(leaf, QuantLeaf)
            else leaf for name, leaf in tree.items()}


@functools.lru_cache(maxsize=None)
def _normalize_consts(device: torch.device):
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (255.0, MNIST_MEAN, MNIST_STD))


def fused_normalize(raw: torch.Tensor) -> torch.Tensor:
    """On-device MNIST normalize, bitwise equal to ``normalize_images``:
    raw uint8 ``(N, 28, 28)`` -> float32 ``(N, 28, 28, 1)``. The constants
    are 0-d tensors on ``raw``'s device so each divide is an IEEE divide
    (the reference hides them behind an optimization barrier for the same
    reason)."""
    c255, mean, std = _normalize_consts(raw.device)
    y = raw.to(torch.float32) / c255
    y = (y - mean) / std
    return y[..., None]


def quant_i8_traced(x: torch.Tensor) -> torch.Tensor:
    """On-device int8 activation quantization, bitwise equal to
    :func:`_quant_i8_host` on finite input: multiply by the same float32
    reciprocal of :data:`ACT_SCALE`, round half to even, clip to +-127."""
    return torch.round(x * _INV_ACT_SCALE).clamp(-127.0, 127.0).to(torch.int8)


def _floating_leaf(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


class ServePrecision:
    """One registered serving precision. The hooks the engine calls:

    - ``quantize(params)`` — host-side, once per param install (boot, hot
      reload), outside the engine lock. Idempotent: ``QuantLeaf`` leaves
      pass through.
    - ``wrap_forward(forward)`` — the split plane's transform (int8
      activations dequantized, weights dequantized, logits cast to f32).
    - ``wrap_fused_forward(forward)`` — raw uint8 -> logits: normalize
      (and quantize activations on ``int8``) on the device, then the SAME
      ``wrap_forward`` transform.
    - ``wrap_stage_forward(forward, first, last)`` — a pipeline stage's
      transform: the first stage takes the staged input dtype, the hop
      to the next stage rides ``hop_dtype`` (``int8`` hops bfloat16, half
      the bytes; re-quantizing activations per boundary would need a
      calibration per publish), and only the last stage casts the logits
      to float32. ``wrap_fused_stage_forward`` prepends the fused
      normalize to the first stage alone.
    - ``stage_host(images, workers)`` — the split plane's host-side activation
      transform before staging (``int8``: quantize with :data:`ACT_SCALE`).

    ``f32`` is the identity on every hook."""

    def __init__(self, name: str, *, weight_cast=None, int8_weights=False,
                 int8_activations=False, act_cast=None,
                 hop_dtype=None) -> None:
        self.name = name
        self.weight_cast = weight_cast  # host-side dtype cast (bf16)
        self.int8_weights = int8_weights
        self.int8_activations = int8_activations
        self.act_cast = act_cast  # on-device activation dtype
        self.hop_dtype = hop_dtype if hop_dtype is not None else act_cast
        self.input_dtype = torch.int8 if int8_activations else torch.float32

    @property
    def identity(self) -> bool:
        return not (self.weight_cast is not None or self.int8_weights
                    or self.int8_activations or self.act_cast is not None)

    def _quantize_leaf(self, leaf):
        """One leaf's install form; a leaf already in it passes through."""
        if isinstance(leaf, QuantLeaf) or not _floating_leaf(leaf):
            return leaf
        if self.int8_weights:
            return quantize_leaf_i8(leaf)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == self.weight_cast:
            return leaf
        return torch.as_tensor(np.asarray(leaf)).to(self.weight_cast)

    def quantize(self, params: Dict[str, object],
                 workers: int = 1) -> Dict[str, object]:
        """Every leaf in its install form, over ``workers`` threads."""
        if not (self.int8_weights or self.weight_cast is not None):
            return params
        names = list(params)
        if workers > 1 and len(names) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(workers, len(names))) as pool:
                leaves = list(pool.map(self._quantize_leaf,
                                       (params[n] for n in names)))
        else:
            leaves = [self._quantize_leaf(params[n]) for n in names]
        return dict(zip(names, leaves))

    def wrap_forward(self, forward):
        if self.identity:
            return forward
        spec = self

        def precision_forward(params, images):
            x = images
            if spec.int8_activations:
                x = x.float() * float(ACT_SCALE)
            if spec.act_cast is not None:
                x = x.to(spec.act_cast)
            p = dequantize_params(params) if spec.int8_weights else params
            return forward(p, x).float()

        return precision_forward

    def wrap_fused_forward(self, forward):
        spec = self
        split = self.wrap_forward(forward)

        def fused_forward(params, raw):
            x = fused_normalize(raw)
            if spec.int8_activations:
                x = quant_i8_traced(x)
            return split(params, x)

        return fused_forward

    def wrap_stage_forward(self, forward, first: bool, last: bool):
        if self.identity:
            return forward
        spec = self

        def stage_forward(params, x):
            if first:
                if spec.int8_activations:
                    x = x.float() * float(ACT_SCALE)
                if spec.act_cast is not None:
                    x = x.to(spec.act_cast)
            else:
                # The hop arrived at hop_dtype: back to the compute dtype.
                x = x.to(spec.act_cast if spec.act_cast is not None
                         else torch.float32)
            p = dequantize_params(params) if spec.int8_weights else params
            y = forward(p, x)
            if last:
                return y.float()
            return y.to(spec.hop_dtype) if spec.hop_dtype is not None else y

        return stage_forward

    def wrap_fused_stage_forward(self, forward, first: bool, last: bool):
        """Only the first stage takes staged bytes, so only its program
        gets the on-device normalize (and int8 quantize); later stages
        keep their :meth:`wrap_stage_forward` programs."""
        base = self.wrap_stage_forward(forward, first, last)
        if not first:
            return base
        spec = self

        def fused_stage(params, raw):
            x = fused_normalize(raw)
            if spec.int8_activations:
                x = quant_i8_traced(x)
            return base(params, x)

        return fused_stage

    def stage_host(self, images: np.ndarray,
                   workers: int = 4) -> np.ndarray:
        if not self.int8_activations:
            return images
        return _quant_i8_host(images, ACT_SCALE, workers)


_PRECISIONS: Dict[str, ServePrecision] = {}


def register_precision(spec: ServePrecision) -> ServePrecision:
    if spec.name in _PRECISIONS:
        raise ValueError(f"serve precision {spec.name!r} already registered")
    _PRECISIONS[spec.name] = spec
    return spec


register_precision(ServePrecision(F32))
register_precision(ServePrecision("bf16", weight_cast=torch.bfloat16))
register_precision(ServePrecision("int8w", int8_weights=True))
register_precision(ServePrecision("int8", int8_weights=True,
                                  int8_activations=True,
                                  hop_dtype=torch.bfloat16))


def serve_precisions() -> List[str]:
    """Every registered precision, ``f32`` first (the default)."""
    return [F32] + sorted(n for n in _PRECISIONS if n != F32)


def get_precision(name: Optional[str]) -> ServePrecision:
    try:
        return _PRECISIONS[name or F32]
    except KeyError:
        raise ValueError(
            f"unknown serve precision {name!r}; registered: "
            f"{serve_precisions()}"
        ) from None


def precision_engine_name(name: Optional[str],
                          precision: Optional[str]) -> Optional[str]:
    """An engine name with its precision suffix (``{name}.{prec}``); f32
    keeps the bare name."""
    if not precision or precision == F32:
        return name
    return f"{name}.{precision}" if name else precision


class MeshPlacement:
    """How one sharded engine places params and runs its forward: the
    mesh group's ``devices`` (``devices[0]`` is the lead), and per param
    leaf one :class:`~pytorch_distributed_mnist_tpu_torch.parallel.
    tensor.Placement` per device (None: the leaf is not split, and lives
    on the lead). Built once per engine by :func:`build_placement`; the
    engine calls :meth:`place_params` at construction and on every hot
    reload (checkpoints of one template share one tree, so the
    placements serve the engine's whole life), :meth:`place_input` per
    dispatched bucket and :meth:`make_forward` once."""

    def __init__(self, mode: str, model_name: str, devices: Sequence,
                 placements: Dict[str, Optional[list]], name: str) -> None:
        self.mode = mode
        self.model_name = model_name
        self.name = name  # engine name suffix: mode, or mode.g{i}
        self.devices = tuple(devices)
        self.lead = self.devices[0]
        self.placements = placements

    def place_params(self, tree: Dict[str, object]) -> List[Dict]:
        """One dict of leaves per device: each split leaf's piece on its
        device, every other leaf on the lead. A quantized leaf's int8
        values split as its float32 leaf does and its scale goes whole
        with every piece."""
        shards: List[Dict] = [{} for _ in self.devices]
        for name, leaf in tree.items():
            pls = self.placements.get(name)
            if pls is None:
                shards[0][name] = _put(leaf, self.lead)
                continue
            for s, (pl, dev) in enumerate(zip(pls, self.devices)):
                if isinstance(leaf, QuantLeaf):
                    piece = QuantLeaf(q=pl.local(_host(leaf.q)), s=leaf.s)
                else:
                    piece = pl.local(_host(leaf))
                shards[s][name] = _put(piece, dev)
        return shards

    def place_input(self, staged: torch.Tensor) -> torch.Tensor:
        """The staged batch on the lead device, where the forward starts;
        the activations reach the other devices inside the forward."""
        return staged.to(self.lead, non_blocking=True)

    def make_forward(self, model):
        """``forward(shards, images) -> logits`` on the lead
        (``serve/sharded.py``)."""
        from pytorch_distributed_mnist_tpu_torch.serve.sharded import (
            make_sharded_forward,
        )

        return make_sharded_forward(self.model_name, model, self.devices)


def _host(leaf):
    """A leaf as the placements slice it: a tensor stays one (on the
    CPU), anything else becomes an array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.cpu()
    return np.asarray(leaf)


def _put(leaf, device: torch.device):
    """One leaf (or a :class:`QuantLeaf` pair) on ``device``."""
    if isinstance(leaf, QuantLeaf):
        return QuantLeaf(q=_put(leaf.q, device),
                         s=torch.tensor(float(leaf.s), dtype=torch.float32,
                                        device=device))
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf.to(device)


def _template_shapes(params) -> Tuple[Dict[str, tuple], str]:
    """``(shapes, root)`` of a params dict or a :class:`ServeTemplate`:
    a dict of the pipeline's split tree (``blocks.`` leaves) has that
    tree's root."""
    if isinstance(params, ServeTemplate):
        return params.shapes, params.root
    shapes = {n: tuple(np.shape(v.q if isinstance(v, QuantLeaf) else v))
              for n, v in params.items()}
    split = any(n.startswith("blocks.") for n in shapes)
    return shapes, "" if split else "['params']"


def _sharded_leaf_dims(params, rules) -> Dict[str, list]:
    """JAX leaf path -> [(dim, size), ...] for every param leaf the rule
    table splits (dims and sizes in the JAX layout); empty means the mode
    is a no-op for this model."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        jax_param_path,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.tensor import jax_shape

    shapes, root = _template_shapes(params)
    out: Dict[str, list] = {}
    for name, shape in shapes.items():
        path = jax_param_path(name, root)
        spec = leaf_spec(path, rules)
        whole = jax_shape(tuple(shape))
        dims = [(dim, whole[dim]) for dim, axis in enumerate(spec)
                if axis is not None]
        if dims:
            out[path] = dims
    return out


def validate_serve_mode(mode: str, model_name: str, mesh_devices: int,
                        params=None) -> None:
    """Refuse unservable model x mode x mesh combinations with flag
    language BEFORE any engine is built.

    Checks: the mode is registered and has a rule table for the model,
    and (with ``params``: a params dict or a :class:`ServeTemplate`)
    every split weight dim divides by the mesh size, the leaf named, as
    the reference words it."""
    if mode == REPLICATED:
        if mesh_devices != 1:
            raise ValueError(
                f"--serve-mode replicated serves one engine per chip; a "
                f"{mesh_devices}-device mesh needs a sharded mode "
                f"({servable_modes(model_name)[1:] or 'none for this model'})"
            )
        return
    spec = _get_mode(mode)
    rules = spec.rules_for(model_name)  # raises for unservable models
    if mesh_devices < 1:
        raise ValueError(f"serve mesh needs >= 1 device, got {mesh_devices}")
    if params is not None:
        sharded = _sharded_leaf_dims(params, rules)
        if not sharded:
            raise ValueError(
                f"--serve-mode {mode}: no param leaf of model "
                f"{model_name!r} matches the {mode} rule table — the mesh "
                f"would replicate everything; use --serve-mode replicated"
            )
        for path, dims in sorted(sharded.items()):
            for dim, size in dims:
                if size % mesh_devices:
                    raise ValueError(
                        f"--serve-mode {mode} over {mesh_devices} devices: "
                        f"param {path} dim {dim} (size {size}) does not "
                        f"divide evenly; pick a mesh size dividing {size}"
                    )


def build_placement(mode: str, model_name: str, devices: Sequence,
                    params, name: Optional[str] = None) -> MeshPlacement:
    """The placements of ONE engine spanning ``devices``, from the param
    names and shapes of ``params`` (a params dict, float32 or installed,
    or a :class:`ServeTemplate`): the rule tables speak the training
    layout.

    ``name`` defaults to the mode itself (``serve_forward_b{b}@{mode}``
    warm-up names on a one-group plane); multi-group pools pass
    ``{mode}.g{i}``."""
    from pytorch_distributed_mnist_tpu_torch.models.convert import (
        jax_param_path,
    )
    from pytorch_distributed_mnist_tpu_torch.parallel.mesh import DataAxis
    from pytorch_distributed_mnist_tpu_torch.parallel.tensor import (
        placement_of,
    )
    from pytorch_distributed_mnist_tpu_torch.utils.device import (
        resolve_device,
    )

    devices = [resolve_device(d) for d in devices]
    validate_serve_mode(mode, model_name, len(devices), params)
    spec = _get_mode(mode)
    rules = spec.rules_for(model_name)
    shapes, root = _template_shapes(params)
    m = len(devices)
    placements: Dict[str, Optional[list]] = {}
    for leaf, shape in shapes.items():
        pspec = leaf_spec(jax_param_path(leaf, root), rules)
        pls = [placement_of(pspec, tuple(shape),
                            DataAxis(m, i, dev, None, spec.axis))
               for i, dev in enumerate(devices)]
        placements[leaf] = None if pls[0] is None else pls
    return MeshPlacement(mode, model_name, devices, placements,
                         name or mode)


def partition_groups(devices: Sequence, mesh_size: int) -> List[list]:
    """Partition ``devices`` into ``mesh_size``-device groups (the pool's
    sharded and staged plane: one spanning engine per group), refusing
    indivisible shapes with flag language.

    Slice-aligned: when an emulated DCN slice map exists
    (``TPUMNIST_DCN_SLICES``, ``parallel/mesh.py::device_slice_map``),
    devices are ordered slice-major before chunking, so a group straddles
    slices only when the mesh size cannot fit in one, and the pool's
    ``/stats`` topology flags exactly those groups
    (``slice_straddling_groups``)."""
    from pytorch_distributed_mnist_tpu_torch.parallel.mesh import (
        device_slice_map,
    )

    devices = list(devices)
    if mesh_size < 1:
        raise ValueError(f"mesh size must be >= 1, got {mesh_size}")
    if len(devices) % mesh_size:
        raise ValueError(
            f"{len(devices)} serve device(s) do not partition into "
            f"{mesh_size}-device mesh groups; --serve-mesh must divide "
            f"--serve-devices"
        )
    smap = device_slice_map(devices)
    if smap is not None:
        order = sorted(range(len(devices)), key=lambda i: (smap[i], i))
        devices = [devices[i] for i in order]
    return [devices[i:i + mesh_size]
            for i in range(0, len(devices), mesh_size)]


def group_name(mode: str, index: int, n_groups: int) -> str:
    """One group's engine name: the bare mode when a single group spans
    the whole pool, ``{mode}.g{i}`` otherwise (and, for staged modes,
    ``{name}.s{k}`` per stage)."""
    return mode if n_groups == 1 else f"{mode}.g{index}"


def build_group_placements(mode: str, model_name: str, devices: Sequence,
                           mesh_size: int, params) -> List[MeshPlacement]:
    """Partition ``devices`` into ``mesh_size``-device groups, one
    :class:`MeshPlacement` per group."""
    groups = partition_groups(devices, mesh_size)
    return [
        build_placement(mode, model_name, group, params,
                        name=group_name(mode, i, len(groups)))
        for i, group in enumerate(groups)
    ]


def build_group_engine(mode: str, model_name: str, devices: Sequence,
                       params, name: str, *, model, buckets, input_shape,
                       serve_log, params_epoch, workers,
                       precision: Optional[str] = None, fuse: bool = False,
                       warmup_log=None):
    """ONE engine spanning ``devices`` for ``mode``: the one place the
    pool's boot, regroup and resize paths construct an engine. The default is a
    :class:`MeshPlacement` and a sharded ``InferenceEngine``; a mode
    with an ``engine_factory`` (the pipeline) builds its own engine
    behind the same surface. ``model`` is a fresh model module (the
    engine's own); ``name`` carries its precision suffix already
    (:func:`precision_engine_name`)."""
    spec = _get_mode(mode)
    if spec.engine_factory is not None:
        return spec.engine_factory(
            model=model, model_name=model_name, params=params,
            devices=list(devices), name=name, buckets=buckets,
            input_shape=input_shape, serve_log=serve_log,
            params_epoch=params_epoch, workers=workers,
            precision=precision, fuse=fuse, warmup_log=warmup_log)
    from pytorch_distributed_mnist_tpu_torch.serve.engine import (
        InferenceEngine,
    )

    placement = build_placement(mode, model_name, list(devices), params,
                                name=name)
    return InferenceEngine(
        model, params, buckets=buckets, input_shape=input_shape,
        serve_log=serve_log, params_epoch=params_epoch, name=name,
        precision=precision, fuse=fuse, workers=workers,
        warmup_log=warmup_log, placement=placement)


def check_checkpoint_layout(layout: Optional[dict], mode: str,
                            model_name: str) -> None:
    """Boot and reload gate: the checkpoint's recorded training parallel
    layout must match the serving mode. A checkpoint trained tensor-,
    expert- or pipeline-parallel is refused under any other mode, naming
    the valid ``--serve-mode``. ``None`` (no stamp) passes; sequence
    parallelism is activation-only and never constrains serving."""
    if not layout:
        return
    trained_axis = {"tensor": "tensor", "expert": "expert",
                    "pipeline": "pipeline"}
    for key, want_mode in trained_axis.items():
        if int(layout.get(key, 1)) > 1 and mode != want_mode:
            raise ValueError(
                f"checkpoint was trained with {key}-parallel "
                f"{layout[key]}; serve it with --serve-mode {want_mode} "
                f"(valid modes for --model {model_name}: "
                f"{servable_modes(model_name)})"
            )


# MODE: pipeline (serve/pipeline.py), registered here like every built-in
# mode so the registry is whole whenever it is importable; its hooks
# import the engine module on first use.
def _pipeline_factory(**kwargs):
    from pytorch_distributed_mnist_tpu_torch.serve.pipeline import (
        pipeline_engine_factory,
    )

    return pipeline_engine_factory(**kwargs)


def _pipeline_template(model_name: str) -> ServeTemplate:
    from pytorch_distributed_mnist_tpu_torch.serve.pipeline import (
        make_pipeline_template,
    )

    return make_pipeline_template(model_name)


register_serve_mode(
    "pipeline", "stage", {"vit": pipeline_stage_rules},
    engine_factory=_pipeline_factory,
    make_template=_pipeline_template,
    staged=True,
)

# Import-time snapshots for docs and tests; anything validating a mode or
# a precision calls serve_modes() / serve_precisions(), the live
# registries.
SERVE_MODES = serve_modes()
SERVE_PRECISIONS = serve_precisions()
