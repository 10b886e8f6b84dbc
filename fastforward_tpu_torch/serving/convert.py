"""Carry serving weights between the JAX package and the port.

The input is a flat ``{path: numpy array}`` dict of a JAX ``ServingParams``
and its stacked layers (plain `ServingLayer` or `FusedServingLayer`), or
of a per-layer ``ServingParams`` (its ``layers`` tuple):

    params.embedding, params.final_norm,
    params.lm_head.<field>          (absent for tied embeddings)
    layers.<projection>.<field>, layers.input_norm, layers.post_norm
                                    (stacked form)
    layers.<i>.<projection>.<field>, layers.<i>.input_norm,
    layers.<i>.post_norm            (per-layer form, i = 0 .. L-1)

where ``<field>`` is an array of a QuantLinear (``data``, ``scale``,
``mult``, ``mult_packed``, ``in_scale``; absent when None) or one of its
static fields (``mode``, ``group_size``, ``paired``) as a 0-d numpy array.
Arrays are copied byte for byte: bf16 arrives as 2-byte words and is
reinterpreted, never converted, so both packages compute the same function
on the same bits. That holds for every mode's arrays: packed int4 or int8
data, or the sim tier's dense data (bf16, or float32 as JAX's
`random_stacked_params` makes it), with f32 scales.
"""

from typing import Dict

import numpy as np
import torch

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.serving.engine import QuantLinear, ServingLayer, ServingParams
from fastforward_tpu_torch.serving.stacked import FusedServingLayer

_QL_ARRAYS = ("data", "scale", "mult", "mult_packed", "in_scale")
_QL_STATIC = ("mode", "group_size", "paired")
_UNFUSED = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
_FUSED = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """Bytes of ``t`` as numpy; bf16 comes back as its int16 words."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _ql(flat: Dict[str, np.ndarray], prefix: str, device) -> QuantLinear:
    arrays = {f: _tensor(flat[f"{prefix}.{f}"], device)
              for f in _QL_ARRAYS if f"{prefix}.{f}" in flat}
    return QuantLinear(
        arrays["data"], arrays["scale"],
        mode=str(flat[f"{prefix}.mode"]),
        group_size=int(flat[f"{prefix}.group_size"]),
        mult=arrays.get("mult"),
        paired=bool(flat[f"{prefix}.paired"]),
        mult_packed=arrays.get("mult_packed"),
        in_scale=arrays.get("in_scale"),
    )


def _layer(flat: Dict[str, np.ndarray], prefix: str, device):
    """The `ServingLayer` (or `FusedServingLayer`) under ``prefix``."""
    fused = f"{prefix}.qkv_proj.data" in flat
    projs = {name: _ql(flat, f"{prefix}.{name}", device)
             for name in (_FUSED if fused else _UNFUSED)}
    norms = dict(
        input_norm=_tensor(flat[f"{prefix}.input_norm"], device),
        post_norm=_tensor(flat[f"{prefix}.post_norm"], device),
    )
    return FusedServingLayer(**projs, **norms) if fused else ServingLayer(**projs, **norms)


def params_from_flat(flat: Dict[str, np.ndarray], device=None):
    """(ServingParams, stacked layers) of the port from a flat dict; for
    the per-layer form (ServingParams with its ``layers`` tuple, None)."""
    dev = resolve_device(device)
    per_layer = "layers.input_norm" not in flat
    n_layers = 0
    while per_layer and f"layers.{n_layers}.input_norm" in flat:
        n_layers += 1
    params = ServingParams(
        embedding=_tensor(flat["params.embedding"], dev),
        layers=tuple(_layer(flat, f"layers.{i}", dev) for i in range(n_layers)),
        final_norm=_tensor(flat["params.final_norm"], dev),
        lm_head=_ql(flat, "params.lm_head", dev) if "params.lm_head.data" in flat else None,
    )
    return params, (None if per_layer else _layer(flat, "layers", dev))


def _put_ql(flat: Dict[str, np.ndarray], prefix: str, ql: QuantLinear) -> None:
    for f in _QL_ARRAYS:
        t = getattr(ql, f)
        if t is not None:
            flat[f"{prefix}.{f}"] = _numpy(t)
    for f in _QL_STATIC:
        flat[f"{prefix}.{f}"] = np.asarray(getattr(ql, f))


def params_to_flat(params: ServingParams, layers=None) -> Dict[str, np.ndarray]:
    """Inverse of `params_from_flat` (bf16 arrays come back as int16
    words): the stacked ``layers`` when given, else ``params.layers``."""
    flat = {
        "params.embedding": _numpy(params.embedding),
        "params.final_norm": _numpy(params.final_norm),
    }

    def put_layer(prefix, layer):
        for name in _FUSED if isinstance(layer, FusedServingLayer) else _UNFUSED:
            _put_ql(flat, f"{prefix}.{name}", getattr(layer, name))
        flat[f"{prefix}.input_norm"] = _numpy(layer.input_norm)
        flat[f"{prefix}.post_norm"] = _numpy(layer.post_norm)

    if params.lm_head is not None:
        _put_ql(flat, "params.lm_head", params.lm_head)
    if layers is not None:
        put_layer("layers", layers)
    for i, layer in enumerate(params.layers):
        put_layer(f"layers.{i}", layer)
    return flat


def moe_block_from_flat(flat: Dict[str, np.ndarray], device=None):
    """The port's `MoEBlock` from a flat dict of a JAX ``MoEBlock``:
    ``router``, ``gate_up.<field>`` and ``down.<field>`` as for a
    QuantLinear above (expert-stacked arrays), ``top_k`` a 0-d array."""
    from fastforward_tpu_torch.serving.moe import MoEBlock

    dev = resolve_device(device)
    return MoEBlock(router=_tensor(flat["router"], dev), gate_up=_ql(flat, "gate_up", dev),
                    down=_ql(flat, "down", dev), top_k=int(flat["top_k"]))


def moe_block_to_flat(block) -> Dict[str, np.ndarray]:
    """Inverse of `moe_block_from_flat` (bf16 arrays as int16 words)."""
    flat = {"router": _numpy(block.router), "top_k": np.asarray(block.top_k)}
    for name in ("gate_up", "down"):
        _put_ql(flat, name, getattr(block, name))
    return flat
