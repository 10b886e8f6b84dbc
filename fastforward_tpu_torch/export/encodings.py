"""Quantization encodings schemas (`fastforward_tpu/export/encodings.py`).

The `EncodingSchemaHandler` protocol with Legacy, V1 and V2 handlers that
produce QNN/AIMET-style encodings JSON from quantizer parameters, and the
LPBQ processor. An encoding entry holds a quantizer's state as numpy
arrays: path, bit width, scale and offset, granularity, symmetry, the
shape of the data it quantizes (in torch's layout: a Linear weight's is
(out, in) where the JAX package's is (in, out)) and the operator that fed
it.
"""

import dataclasses
from typing import Any, Optional, Protocol

import numpy as np

from fastforward_tpu_torch.quantization import affine
from fastforward_tpu_torch.quantization.granularity import (
    Granularity,
    PerBlock,
    PerChannel,
)


@dataclasses.dataclass
class QuantizerEncoding:
    """Raw quantizer state collected from a model."""

    name: str
    num_bits: int
    scale: np.ndarray  # flat per-tile scales
    offset: Optional[np.ndarray]
    granularity: Granularity
    symmetric: bool
    data_shape: Optional[tuple[int, ...]] = None
    # the operator that fed this quantizer, recorded by
    # `quantization.quantizer_annotations.annotate_operator_metadata`
    producing_operator: Optional[str] = None


class EncodingSchemaHandler(Protocol):
    """Turns encoding entries into one schema's JSON object."""

    version: str

    def encode(self, encodings: list[QuantizerEncoding]) -> dict[str, Any]: ...


def _minmax(e: QuantizerEncoding) -> tuple[np.ndarray, np.ndarray]:
    offset = e.offset if e.offset is not None else 0.0
    mn = (affine.integer_minimum(e.num_bits) + offset) * e.scale
    mx = (affine.integer_maximum(e.num_bits) + offset) * e.scale
    return np.asarray(mn), np.asarray(mx)


class LegacySchemaHandler:
    """AIMET legacy list-of-dicts schema."""

    version = "0.6.1"

    def encode(self, encodings: list[QuantizerEncoding]) -> dict[str, Any]:
        out: dict[str, Any] = {"version": self.version, "activation_encodings": {},
                               "param_encodings": {}}
        for e in encodings:
            mn, mx = _minmax(e)
            entries = []
            for i in range(e.scale.size):
                entries.append({
                    "bitwidth": e.num_bits,
                    "dtype": "int",
                    "is_symmetric": str(e.symmetric),
                    "max": float(np.ravel(mx)[i]),
                    "min": float(np.ravel(mn)[i]),
                    "offset": float(np.ravel(e.offset)[i]) if e.offset is not None else 0.0,
                    "scale": float(np.ravel(e.scale)[i]),
                })
            section = "param_encodings" if "param" in e.name or "weight" in e.name else "activation_encodings"
            out[section][e.name] = entries
        return out


class V1SchemaHandler:
    """Per-tensor/per-channel schema."""

    version = "1.0.0"

    def encode(self, encodings: list[QuantizerEncoding]) -> dict[str, Any]:
        entries = []
        for e in encodings:
            if isinstance(e.granularity, PerChannel):
                enc_type = "PER_CHANNEL"
            elif isinstance(e.granularity, PerBlock):
                enc_type = "PER_BLOCK"
            else:
                enc_type = "PER_TENSOR"
            entries.append({
                "name": e.name,
                "enc_type": enc_type,
                "dtype": "INT",
                "bw": e.num_bits,
                "is_sym": e.symmetric,
                "scale": np.ravel(e.scale).tolist(),
                "offset": np.ravel(e.offset).tolist() if e.offset is not None
                else [0.0] * e.scale.size,
                **({"op": e.producing_operator}
                   if e.producing_operator else {}),
            })
        return {"version": self.version, "encodings": entries}


class V2SchemaHandler:
    """Per-block / LPBQ-capable schema."""

    version = "2.0.0"

    def __init__(self, lpbq: Optional["LPBQProcessor"] = None):
        self.lpbq = lpbq

    def encode(self, encodings: list[QuantizerEncoding]) -> dict[str, Any]:
        entries = []
        for e in encodings:
            entry: dict[str, Any] = {
                "name": e.name,
                "dtype": "INT",
                "bw": e.num_bits,
                "is_sym": e.symmetric,
            }
            if isinstance(e.granularity, PerBlock) and e.data_shape is not None:
                tile = e.granularity.tile_size(e.data_shape)
                entry["enc_type"] = "PER_BLOCK"
                entry["block_size"] = list(tile)
                if self.lpbq is not None:
                    entry.update(self.lpbq.process(e))
                else:
                    entry["scale"] = np.ravel(e.scale).tolist()
            else:
                entry["enc_type"] = (
                    "PER_CHANNEL" if isinstance(e.granularity, PerChannel) else "PER_TENSOR"
                )
                entry["scale"] = np.ravel(e.scale).tolist()
            if e.offset is not None:
                entry["offset"] = np.ravel(e.offset).tolist()
            if e.producing_operator:
                entry["op"] = e.producing_operator
            entries.append(entry)
        return {"version": self.version, "encodings": entries}


class LPBQProcessor:
    """Low-power blockwise quantization of per-block scales.

    Per-block float scales re-expressed as per-block *integer* multipliers
    (compressed_bw bits) times one per-channel float scale.
    """

    def __init__(self, compressed_bw: int = 4, decompressed_bw: int = 8):
        self.compressed_bw = compressed_bw
        self.decompressed_bw = decompressed_bw

    def process(self, e: QuantizerEncoding) -> dict[str, Any]:
        if not isinstance(e.granularity, PerBlock) or e.data_shape is None:
            raise ValueError("LPBQ requires PerBlock granularity with data shape")
        tile = e.granularity.tile_size(e.data_shape)
        grid = tuple(d // t for d, t in zip(e.data_shape, tile))
        scales = np.asarray(e.scale, dtype=np.float64).reshape(grid)

        # Channel axis = the per-channel dims of the granularity (grid dim
        # equal to the data dim); blocks vary along the block dims.
        ch_axes = tuple(
            i for i, (g, d) in enumerate(zip(grid, e.data_shape)) if g == d
        ) or (0,)
        block_axes = tuple(i for i in range(len(grid)) if i not in ch_axes)

        steps = 2**self.compressed_bw - 1
        per_channel = scales.max(axis=block_axes, keepdims=True) / steps
        int_scales = np.clip(np.round(scales / per_channel), 1, steps).astype(int)
        return {
            "compressed_bw": self.compressed_bw,
            "decompressed_bw": self.decompressed_bw,
            "per_channel_float_scale": np.ravel(per_channel).tolist(),
            "per_block_int_scale": np.ravel(int_scales).tolist(),
        }

    def reconstruct(self, entry: dict[str, Any], grid: tuple[int, ...],
                    ch_axes: tuple[int, ...]) -> np.ndarray:
        """Rebuild approximate per-block float scales from LPBQ fields."""
        per_channel_shape = tuple(
            g if i in ch_axes else 1 for i, g in enumerate(grid)
        )
        pc = np.asarray(entry["per_channel_float_scale"]).reshape(per_channel_shape)
        ints = np.asarray(entry["per_block_int_scale"]).reshape(grid)
        return ints * pc


SCHEMA_HANDLERS = {
    "legacy": LegacySchemaHandler,
    "v1": V1SchemaHandler,
    "v2": V2SchemaHandler,
}
