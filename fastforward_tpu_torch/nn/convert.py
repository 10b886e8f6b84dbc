"""Carry a flax NNX model's parameters into its converted `torch.nn`
counterpart (as `serving/convert.py` carries serving weights).

The parameters come as numpy arrays by path: ``"fc1/kernel"``,
``"layers/0/weight_quantizer/scale"``, ... (NNX attribute names joined with
``/``; an ``nnx.Sequential``'s ``layers`` step stands for the torch
container's own children). Each lands in torch's layout:

- a Linear ``kernel`` (in, out) becomes ``weight`` (out, in);
- a convolution ``kernel`` (*k, in / groups, out) becomes ``weight``
  (out, in / groups, *k);
- ``embedding`` becomes ``weight``; a norm's ``scale`` becomes ``weight``;
  an `Einsum` ``kernel`` becomes ``weight`` as it is (its einsum string
  fixes the layout);
- bf16 arrays (flax's bf16 parameters) come over through f32, exactly;
- a `LinearQuantizer`'s ``scale`` and ``offset`` are reordered into the
  tile order of the tensor its slot quantizes in torch's layout (this
  matters where the tiles span more than one dim, e.g. a
  ``PerBlock(block_dims=0, per_channel_dims=1)`` grid on a (in, out)
  kernel).

`transpose_granularity` maps a granularity on the NNX layout to the port's
on torch's layout for a given permutation of dims, so that one spec can
configure both sides. It reads the granularity's class name and fields, so
it takes the JAX package's granularities as well as the port's.
"""

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from fastforward_tpu_torch.nn import layers
from fastforward_tpu_torch.nn.linear_quantizer import LinearQuantizer
from fastforward_tpu_torch.quantization import granularity as granularities
from fastforward_tpu_torch.quantization import tiling

__all__ = ["load_nnx_params", "transpose_granularity", "LINEAR_WEIGHT_PERM",
           "conv_weight_perm", "channels_last_perm"]

# torch dim j of a Linear weight is NNX kernel dim LINEAR_WEIGHT_PERM[j]
LINEAR_WEIGHT_PERM = (1, 0)


def conv_weight_perm(nd: int) -> tuple:
    """torch (out, in, *k) from NNX (*k, in, out): dim j of the torch
    weight is dim perm[j] of the NNX kernel."""
    return (nd + 1, nd) + tuple(range(nd))


def channels_last_perm(ndim: int) -> tuple:
    """An N, C, spatial... activation from an N, spatial..., C one."""
    return (0, ndim - 1) + tuple(range(1, ndim - 1))


def _dims(dims: Sequence[int], perm: Sequence[int]) -> tuple:
    n = len(perm)
    return tuple(perm.index(d % n) for d in dims)


def transpose_granularity(gran: Any, perm: Sequence[int]) -> granularities.Granularity:
    """The port's granularity on ``torch_tensor = nnx_array.transpose(perm)``
    for ``gran`` on the NNX array (PerTensor, PerChannel, PerBlock or
    PerTile, of either package)."""
    perm = tuple(perm)
    kind = type(gran).__name__
    if kind == "PerTensor":
        return granularities.PerTensor()
    if kind == "PerChannel":
        return granularities.PerChannel(_dims(gran.channel_dims, perm))
    if kind == "PerBlock":
        order = sorted(range(len(gran.block_dims)),
                       key=lambda i: perm.index(gran.block_dims[i] % len(perm)))
        return granularities.PerBlock(
            tuple(perm.index(gran.block_dims[i] % len(perm)) for i in order),
            tuple(gran.block_sizes[i] for i in order),
            _dims(gran.per_channel_dims, perm),
            strict_blocks=gran.strict_blocks)
    if kind == "PerTile":
        return granularities.PerTile(tuple(gran.tile_shape[p] for p in perm))
    raise TypeError(f"no mapping for granularity {gran!r}")


def _reorder_tiles(values: np.ndarray, gran: granularities.Granularity,
                   torch_shape: Sequence[int], perm: Sequence[int]) -> np.ndarray:
    """Per-tile parameters in the NNX tensor's tile order, reordered into
    the tile order of the torch tensor (``perm`` of the NNX one)."""
    values = np.asarray(values)
    tile = gran.tile_size(tuple(torch_shape))
    if isinstance(tile, str) or values.size <= 1:
        return values
    grid_torch = tiling.tile_grid(tuple(torch_shape), tile)
    grid_nnx = tuple(grid_torch[perm.index(i)] for i in range(len(perm)))
    return values.reshape(grid_nnx).transpose(perm).reshape(-1)


def _slot_permutation(layer: torch.nn.Module, slot: str, data_ndim: int) -> tuple:
    """The dims permutation from the NNX layout to torch's of the tensor
    that quantizer ``slot`` of ``layer`` sees."""
    conv = isinstance(layer, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Conv3d))
    if slot == "weight_quantizer":
        if isinstance(layer, torch.nn.Linear):
            return LINEAR_WEIGHT_PERM
        if conv:
            return conv_weight_perm(data_ndim - 2)
    if slot in ("input_quantizer", "output_quantizer") and conv:
        return channels_last_perm(data_ndim)
    return tuple(range(data_ndim))


def _slot_shape(layer: torch.nn.Module, slot: str) -> Optional[tuple]:
    """The torch shape of the tensor a parameter quantizer slot sees."""
    name = {"weight_quantizer": "weight", "bias_quantizer": "bias"}.get(slot)
    param = getattr(layer, name, None) if name else None
    return None if param is None else tuple(param.shape)


def _resolve(model: torch.nn.Module, parts: Sequence[str]):
    """(owner module, its parent, the owner's name) for an NNX path's
    module steps."""
    module, parent, name = model, None, None
    for part in parts:
        if part == "layers" and isinstance(module, (torch.nn.Sequential, torch.nn.ModuleList)):
            continue
        parent, name = module, part
        module = module[int(part)] if isinstance(
            module, (torch.nn.Sequential, torch.nn.ModuleList)) else getattr(module, part)
    return module, parent, name


_LEAF = {"embedding": "weight", "scale": "weight", "kernel": "weight", "bias": "bias"}


def load_nnx_params(model: torch.nn.Module, params: Mapping[str, np.ndarray]) -> None:
    """Copy ``params`` (NNX path → numpy array) into ``model``, a torch
    model converted with `quantize_model` whose module tree matches the NNX
    one's and whose `LinearQuantizer`s are in place. An activation
    quantizer's tiles must lie along one dim at most (its data shape is not
    known here, so neither is a reordering)."""
    for path, value in params.items():
        parts = path.split("/")
        owner, parent, owner_name = _resolve(model, parts[:-1])
        leaf = parts[-1]
        value = np.asarray(value)
        if isinstance(owner, LinearQuantizer):
            if leaf not in ("scale", "offset"):
                raise KeyError(f"{path}: a LinearQuantizer holds scale and offset only")
            shape = _slot_shape(parent, owner_name)
            if shape is not None:
                perm = _slot_permutation(parent, owner_name, len(shape))
                value = _reorder_tiles(value, owner.granularity, shape, perm)
            elif not _one_dim_grid(owner.granularity):
                raise ValueError(f"{path}: {owner.granularity!r} on an activation; its tile "
                                 "order in torch's layout is unknown")
            tensor = torch.from_numpy(np.array(value, dtype=np.float32))
            grad = leaf == "scale" or not owner._one_sided
            setattr(owner, leaf, torch.nn.Parameter(tensor, requires_grad=grad))
            continue
        if leaf not in _LEAF:
            raise KeyError(f"{path}: no torch counterpart for NNX parameter {leaf!r}")
        target = getattr(owner, _LEAF[leaf])
        if leaf == "kernel" and isinstance(owner, torch.nn.Linear):
            value = value.T
        elif leaf == "kernel" and isinstance(owner, (torch.nn.Conv1d, torch.nn.Conv2d,
                                                     torch.nn.Conv3d)):
            value = value.transpose(conv_weight_perm(value.ndim - 2))
        elif leaf == "kernel" and not isinstance(owner, layers.Einsum):
            raise KeyError(f"{path}: a kernel of {type(owner).__name__}")
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{path}: shape {value.shape} for {tuple(target.shape)}")
        if value.dtype.name == "bfloat16":  # numpy's bf16 (ml_dtypes): through f32, exactly
            value = value.astype(np.float32)
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.array(value)).to(target.dtype))


def _one_dim_grid(gran: granularities.Granularity) -> bool:
    """Whether the tiles of ``gran`` lie along one dim at most, so that any
    permutation of the data's dims keeps their order."""
    if isinstance(gran, granularities.PerTensor):
        return True
    return isinstance(gran, granularities.PerChannel) and len(gran.channel_dims) == 1
