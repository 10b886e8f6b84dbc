"""Quantization-state and params checkpoints
(`fastforward_tpu/utils/checkpoint.py`).

**Quantization state** (`save_quantization_state` / `load_quantization_state`,
the JAX functions' arguments, errors and warnings): ``<path>/config.yaml``
reconstructs each quantizer (type and constructor arguments, its tensors'
keys, ``shared_with`` for a quantizer met again at a later path, the
``::lazy`` marker for a parameter not yet set, the format version and an
optional ``name_or_path``), and ``<path>/quantizers.safetensors`` holds the
scales and offsets. Paths are the JAX package's: the quantizer's module
names joined by ``/``, in `named_quantizers`' order. ``config.yaml`` is
written and read by `block_yaml` (the text ``yaml.safe_dump`` writes) and
the tensors by the loader's own safetensors writer and reader, so neither
PyYAML nor the ``safetensors`` package is needed.

A state written by the JAX package loads too: its ``fastforward_tpu.``
type names are read as the port's (`serialization.port_name`), and a
parameter quantizer's granularity and tiles, on JAX's layout of the
tensor ((in, out) for a Linear kernel), are carried onto torch's layout
as `nn.convert.load_nnx_params` carries them.

**Params** (`save_params` / `load_params`): any tree of dicts, lists,
tuples and dataclasses (`ServingParams`, `QuantLinear`, `QuantizedTensor`
and its quantization context) whose leaves are tensors or plain values.
``<path>/params.safetensors`` holds the tensors keyed by their path, as
they lie (packed int4 and int8 bytes are never dequantized);
``<path>/spec.json`` the tree (containers as `torch.utils._pytree` tree
specs) with the dataclasses' type names and their non-tensor fields. No
pickle is written or read.
"""

import dataclasses
import json
import os
import types
import warnings
from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.exceptions import QuantizationError
from fastforward_tpu_torch.nn.quantized_module import named_quantizers
from fastforward_tpu_torch.nn.quantizer import Quantizer, QuantizerStub
from fastforward_tpu_torch.quantization.granularity import Granularity
from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor
from fastforward_tpu_torch.serving.loader import read_safetensors, write_safetensors
from fastforward_tpu_torch.utils import block_yaml, serialization
from fastforward_tpu_torch.utils.common import fully_qualified_name

FORMAT_VERSION = "1.0"
LAZY_MARKER = "::lazy"
CONFIG_FILE = "config.yaml"
TENSORS_FILE = "quantizers.safetensors"
PARAMS_FILE = "params.safetensors"
SPEC_FILE = "spec.json"


# -- quantization state ---------------------------------------------------------


def _quantizer_config(quantizer: Quantizer) -> dict[str, Any]:
    from fastforward_tpu_torch.nn.linear_quantizer import DynamicLinearQuantizer, LinearQuantizer

    config: dict[str, Any] = {"type": fully_qualified_name(type(quantizer)), "args": {},
                              "params": {}}
    if isinstance(quantizer, (LinearQuantizer, DynamicLinearQuantizer)):
        config["args"] = {
            "num_bits": quantizer.num_bits,
            "granularity": serialization.to_yamlable_dict(quantizer.granularity),
            "symmetric": quantizer.symmetric,
            "allow_one_sided": quantizer.allow_one_sided,
        }
    if isinstance(quantizer, LinearQuantizer):
        if quantizer.scale is None:
            config["params"]["scale"] = LAZY_MARKER
            config["params"]["offset"] = LAZY_MARKER
        else:
            config["params"]["scale"] = "scale"
            config["params"]["offset"] = None if quantizer.offset is None else "offset"
    return config


def save_quantization_state(
    model: torch.nn.Module,
    path: str,
    *,
    name_or_path: Optional[str] = None,
    allow_lazy_params: bool = False,
) -> None:
    """Write ``<path>/config.yaml`` + ``<path>/quantizers.safetensors``.

    ``name_or_path``: an optional model identity recorded in the state;
    loading against another identity warns. ``allow_lazy_params``: a
    quantizer whose parameters are not set raises unless this is set, in
    which case its parameters are recorded as ``::lazy`` markers.
    """
    os.makedirs(path, exist_ok=True)
    tensors: dict[str, torch.Tensor] = {}
    configs: dict[str, Any] = {}
    seen: dict[int, str] = {}  # id(quantizer) -> the first path it was met at

    for dotted, quantizer in named_quantizers(model):
        name = dotted.replace(".", "/")
        if isinstance(quantizer, QuantizerStub):
            continue
        if id(quantizer) in seen:
            configs[name] = {"shared_with": seen[id(quantizer)]}
            continue
        seen[id(quantizer)] = name
        config = _quantizer_config(quantizer)
        lazy = [p for p, key in config["params"].items() if key == LAZY_MARKER]
        if lazy and not allow_lazy_params:
            raise QuantizationError(
                f"Quantizer at {name!r} has uninitialized (lazy) parameters "
                f"{lazy}; calibrate first or pass allow_lazy_params=True to "
                f"record them as lazy markers."
            )
        for param_name, key in list(config["params"].items()):
            if key in (None, LAZY_MARKER):
                continue
            tensor_key = f"{name}.{param_name}"
            tensors[tensor_key] = getattr(quantizer, param_name).detach()
            config["params"][param_name] = tensor_key
        configs[name] = config

    meta: dict[str, Any] = {"version": FORMAT_VERSION, "quantizers": configs}
    if name_or_path is not None:
        meta["name_or_path"] = name_or_path
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        f.write(block_yaml.safe_dump(meta))
    write_safetensors(os.path.join(path, TENSORS_FILE), tensors)


def _slot_device(module: Optional[torch.nn.Module], model: torch.nn.Module) -> torch.device:
    """The device of the slot's module (its first parameter or buffer),
    else the model's, else the CPU."""
    for m in (module, model):
        if m is None:
            continue
        for t in (*m.parameters(), *m.buffers()):
            return t.device
    return torch.device("cpu")


def _to_torch_layout(quantizer, tensors: dict, parent, slot: str) -> dict:
    """A JAX-written quantizer's granularity and tiles on torch's layout of
    the tensor its slot quantizes (`nn.convert.load_nnx_params`'s rule)."""
    from fastforward_tpu_torch.nn import convert

    conv = isinstance(parent, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Conv3d))
    shape = convert._slot_shape(parent, slot)
    ndim = len(shape) if shape is not None else (parent.weight.dim() if conv else None)
    perm = convert._slot_permutation(parent, slot, ndim) if ndim is not None else None
    if perm is None or perm == tuple(range(len(perm))):
        return tensors
    gran = convert.transpose_granularity(quantizer.granularity, perm)
    if shape is None and not convert._one_dim_grid(quantizer.granularity):
        raise QuantizationError(f"{quantizer.granularity!r} on the activation slot {slot!r} of "
                                f"{type(parent).__name__}: its tile order on torch's layout is "
                                "unknown")
    out = {}
    for key, t in tensors.items():
        if shape is not None:
            t = torch.from_numpy(convert._reorder_tiles(t.numpy(), gran, shape, perm).copy())
        out[key] = t
    quantizer.granularity = gran
    return out


def _parent_of(root: torch.nn.Module, path: tuple) -> torch.nn.Module:
    parent = root
    for seg in path[:-1]:
        parent = getattr(parent, seg)  # a container's children are attributes too ("0")
    return parent


def load_quantization_state(
    model: torch.nn.Module,
    path: str,
    overwrite_policy: str = "overwrite",
    *,
    name_or_path: Optional[str] = None,
    allow_lazy_params: bool = False,
) -> None:
    """Reconstruct quantizers from a saved state onto ``model`` (in place),
    each scale and offset on the device of its slot's module.

    ``overwrite_policy``: "error" | "skip" | "overwrite" for slots already
    holding quantizers that are not stubs. ``name_or_path``: when given and
    the state recorded another identity, a warning is emitted.
    ``allow_lazy_params``: a state with ``::lazy`` markers raises unless
    this is set (the loaded quantizer would be silently uncalibrated).
    """
    from fastforward_tpu_torch import mpath

    config_file = os.path.join(path, CONFIG_FILE)
    model_file = os.path.join(path, TENSORS_FILE)
    if not os.path.exists(config_file):
        raise QuantizationError(f"Quantization state config not found: {config_file}")
    if not os.path.exists(model_file):
        raise QuantizationError(f"Quantization state tensors not found: {model_file}")
    with open(config_file) as f:
        saved = block_yaml.safe_load(f.read())
    if saved.get("version") != FORMAT_VERSION:
        raise QuantizationError(
            f"Unsupported quantization state version {saved.get('version')}"
        )
    stored_name = saved.get("name_or_path")
    if name_or_path is not None and stored_name is not None and stored_name != name_or_path:
        warnings.warn(
            f"Quantization state was saved for {stored_name!r} but is being "
            f"loaded for {name_or_path!r}",
            stacklevel=2,
        )
    if not allow_lazy_params:
        lazy_names = [
            n for n, c in saved["quantizers"].items()
            if any(v == LAZY_MARKER for v in c.get("params", {}).values())
        ]
        if lazy_names:
            raise QuantizationError(
                f"Quantization state contains lazy (uncalibrated) quantizers "
                f"{lazy_names}; pass allow_lazy_params=True to load them "
                f"uninitialized."
            )
    tensors = read_safetensors(model_file)

    def slot(name: str):
        items = list(mpath.search(name, model))
        if len(items) != 1:
            raise QuantizationError(f"Quantizer path {name!r} not found in model")
        return items[0]

    built: dict[str, Quantizer] = {}

    def build(name: str, config: dict[str, Any]) -> Quantizer:
        if "shared_with" in config:
            return built[config["shared_with"]]
        cls = serialization.resolve_name(config["type"])
        args = {k: serialization._decode(v) for k, v in config.get("args", {}).items()}
        quantizer = cls(**args)
        params = config.get("params", {})
        scale_key = params.get("scale")
        if scale_key and scale_key != LAZY_MARKER:
            offset_key = params.get("offset")
            found = {"scale": tensors[scale_key]}
            if offset_key:
                found["offset"] = tensors[offset_key]
            item = slot(name)
            parent = _parent_of(model, item.path)
            if not config["type"].startswith("fastforward_tpu_torch."):
                found = _to_torch_layout(quantizer, found, parent, item.path[-1])
            dev = _slot_device(parent, model)
            quantizer.scale = torch.nn.Parameter(found["scale"].to(dev))
            if "offset" in found:
                quantizer._one_sided = bool(getattr(quantizer, "symmetric", False))
                quantizer.offset = torch.nn.Parameter(found["offset"].to(dev),
                                                      requires_grad=not quantizer._one_sided)
            else:
                quantizer.offset = None
        return quantizer

    # Build in order so shared_with targets exist first.
    configs = saved["quantizers"]
    for name in sorted(configs, key=lambda n: ("shared_with" in configs[n], n)):
        built[name] = build(name, configs[name])

    for name, quantizer in built.items():
        item = slot(name)
        current = item.module
        if not isinstance(current, QuantizerStub) and isinstance(current, Quantizer):
            if overwrite_policy == "error":
                raise QuantizationError(
                    f"Quantizer at {name!r} already initialized (policy=error)"
                )
            if overwrite_policy == "skip":
                continue
        item.update_module(quantizer)


# -- params -------------------------------------------------------------------


def _key_part(k: Any) -> str:
    for attr in ("idx", "key", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _join(key: str, part: str) -> str:
    return f"{key}.{part}" if key else part


def _encode_leaf(node: Any, key: str, tensors: dict[str, torch.Tensor]) -> Any:
    """The JSON spec of one node of the params tree; its tensors into
    ``tensors`` under keys from ``key``."""
    if isinstance(node, torch.Tensor):
        if key in tensors:
            raise ValueError(f"two tensors at the path {key!r}")
        tensors[key] = node.detach()
        return {"tensor": key}
    if isinstance(node, QuantizedTensor):
        return {"quantized": {
            "raw_data": _encode_leaf(node.raw_data, _join(key, "raw_data"), tensors),
            "context": _encode_leaf(node.quantization_context, _join(key, "context"), tensors)}}
    if isinstance(node, Granularity):
        return {"yamlable": serialization.to_yamlable_dict(node)}
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return {"dataclass": fully_qualified_name(type(node)),
                "fields": {f.name: _encode_leaf(getattr(node, f.name), _join(key, f.name),
                                                tensors)
                           for f in dataclasses.fields(node)}}
    if isinstance(node, torch.dtype):
        return {"dtype": str(node)}
    if isinstance(node, (type, types.FunctionType, types.BuiltinFunctionType)):
        return {"name": fully_qualified_name(node)}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    flat, spec = pytree.tree_flatten_with_path(node)
    if spec.is_leaf():
        raise TypeError(f"save_params cannot save a {type(node).__name__} at {key!r}")
    return {"tree": pytree.treespec_dumps(spec),
            "leaves": [_encode_leaf(leaf, ".".join([key] * bool(key) + [_key_part(k) for k in kp]),
                                    tensors)
                       for kp, leaf in flat]}


def save_params(params: Any, path: str) -> int:
    """Save a params tree (quantized leaves included) into the directory
    ``path``: ``params.safetensors`` and ``spec.json``. Returns the bytes
    written."""
    os.makedirs(path, exist_ok=True)
    tensors: dict[str, torch.Tensor] = {}
    spec = _encode_leaf(params, "", tensors)
    with open(os.path.join(path, SPEC_FILE), "w") as f:
        json.dump({"version": FORMAT_VERSION, "spec": spec}, f)
    write_safetensors(os.path.join(path, PARAMS_FILE), tensors)
    return sum(os.path.getsize(os.path.join(path, n)) for n in (SPEC_FILE, PARAMS_FILE))


def _mismatch(what: str, key: str) -> ValueError:
    return ValueError(f"load_params: {what} at {key or 'the root'!r} differs from the template")


def _restore(spec: dict, tensors: dict, template: Any, dev: torch.device, key: str = "") -> Any:
    """The node of ``spec``: on the template's types, dtypes and devices
    where a template is given (``template`` not `_NO_TEMPLATE`), else as
    nested dicts on ``dev``."""
    free = template is _NO_TEMPLATE
    kind = next(iter(spec))
    body = spec[kind]
    if kind == "tensor":
        t = tensors[body]
        if free:
            return t.to(dev)
        if not isinstance(template, torch.Tensor):
            raise _mismatch("a tensor", body)
        if t.dtype != template.dtype or tuple(t.shape) != tuple(template.shape):
            raise ValueError(f"load_params: {body!r} is {t.dtype} {tuple(t.shape)}, the "
                             f"template's {template.dtype} {tuple(template.shape)}")
        return t.to(template.device)
    if kind == "quantized":
        if free:
            return {"raw_data": _restore(body["raw_data"], tensors, template, dev),
                    "quantization_context": _restore(body["context"], tensors, template, dev)}
        if not isinstance(template, QuantizedTensor):
            raise _mismatch("a QuantizedTensor", key)
        return QuantizedTensor(_restore(body["raw_data"], tensors, template.raw_data, dev),
                               _restore(body["context"], tensors, template.quantization_context,
                                        dev))
    if kind == "dataclass":
        name, saved_fields = body, spec["fields"]
        if free:
            return {k: _restore(v, tensors, template, dev) for k, v in saved_fields.items()}
        if not dataclasses.is_dataclass(template) or fully_qualified_name(type(template)) != name:
            raise _mismatch(f"the dataclass {name}", key)
        if {f.name for f in dataclasses.fields(template)} != set(saved_fields):
            raise _mismatch(f"the fields of {name}", key)
        return dataclasses.replace(template, **{
            k: _restore(v, tensors, getattr(template, k), dev, _join(key, k))
            for k, v in saved_fields.items()})
    if kind == "yamlable":
        value = serialization.from_yamlable_dict(body)
        if not free and value != template:
            raise _mismatch(f"the granularity {value!r}", key)
        return value if free else template
    if kind == "dtype":
        value = getattr(torch, body.split(".")[-1])
        if not free and value != template:
            raise _mismatch(f"the dtype {body}", key)
        return value
    if kind == "name":
        if free:
            return body
        if fully_qualified_name(template) != body:
            raise _mismatch(f"the name {body}", key)
        return template
    if kind == "value":
        if not free and (type(body) is not type(template) or body != template):
            raise _mismatch(f"the value {body!r}", key)
        return body if free else template
    if kind == "tree":
        treespec = pytree.treespec_loads(body)
        if free:
            leaves = [_restore(s, tensors, template, dev) for s in spec["leaves"]]
            return pytree.tree_unflatten(leaves, treespec)
        t_leaves, t_spec = pytree.tree_flatten(template)
        if t_spec != treespec:
            raise _mismatch("the tree structure", key)
        leaves = [_restore(s, tensors, t, dev, key) for s, t in zip(spec["leaves"], t_leaves)]
        return pytree.tree_unflatten(leaves, t_spec)
    raise ValueError(f"load_params: unknown spec entry {kind!r}")


_NO_TEMPLATE = object()


def load_params(path: str, template: Optional[Any] = None, *, device=None) -> Any:
    """Restore a tree saved by `save_params`.

    ``template``: a like-structured tree (e.g. the params that were saved,
    or fresh ones of the same configuration). The result takes its
    dataclass types, dtypes and devices; any difference of structure,
    type, non-tensor field, shape or dtype raises. Without one, the tree
    comes back as nested dicts, lists and tuples of tensors on ``device``
    (default: the GPU).
    """
    with open(os.path.join(path, SPEC_FILE)) as f:
        saved = json.load(f)
    if saved.get("version") != FORMAT_VERSION:
        raise ValueError(f"Unsupported params format version {saved.get('version')}")
    tensors = read_safetensors(os.path.join(path, PARAMS_FILE))
    if template is None:
        return _restore(saved["spec"], tensors, _NO_TEMPLATE, resolve_device(device))
    return _restore(saved["spec"], tensors, template, None)
