"""Quantization granularities (`fastforward_tpu/quantization/granularity.py`).

A granularity maps a data shape to a *tile size*; one (scale, offset) pair
is used per tile: one for the tensor, one per channel, per block, or per
arbitrary tile. Granularities are immutable and hashable.

The four concrete classes are registered for YAML as the JAX ones are
(`utils.serialization.yamlable`: their constructor arguments recorded, so a
quantization state's ``config.yaml`` can name them); only
`utils.serialization.dump` and ``load`` import PyYAML.
"""

import abc
from typing import Any, Literal, Sequence

from fastforward_tpu_torch.quantization.tiling import check_tile_compatibility
from fastforward_tpu_torch.utils.serialization import yamlable

Shape = tuple[int, ...]
TileSize = tuple[int, ...]


def _as_tuple(value: int | Sequence[int]) -> tuple[int, ...]:
    if isinstance(value, int):
        return (value,)
    return tuple(value)


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


class Granularity(abc.ABC):
    """Base class for parameter-sharing granularities.

    Subclasses implement ``tile_size(data_shape)`` returning either a concrete
    tile shape or the literal string ``"data_shape"`` (whole-tensor tile).
    """

    @abc.abstractmethod
    def tile_size(self, data_shape: Sequence[int]) -> TileSize | Literal["data_shape"]:
        """Return the tile size used over ``data_shape``."""
        raise NotImplementedError

    def parameter_dimensionality(self, data_shape: Sequence[int]) -> int:
        """Number of parameter elements (tiles) for ``data_shape``."""
        tile = self.tile_size(data_shape)
        if isinstance(tile, str):
            return 1
        return _numel(data_shape) // _numel(tile)

    def repr_args(self) -> dict[str, Any]:
        return {}

    def __repr__(self) -> str:
        args = ", ".join(f"{k}={v}" for k, v in self.repr_args().items())
        return f"{type(self).__name__}({args})"

    def __eq__(self, other: object) -> bool:
        if type(self) is not type(other):
            return False
        return self._key() == other._key()  # type: ignore[attr-defined]

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._key()))

    def _key(self) -> tuple[Any, ...]:
        return ()


@yamlable
class PerTensor(Granularity):
    """One parameter set for the whole tensor."""

    def tile_size(self, data_shape: Sequence[int]) -> Literal["data_shape"]:
        return "data_shape"


@yamlable
class PerChannel(Granularity):
    """One parameter set per index along ``channel_dims``."""

    def __init__(self, channel_dim: int | Sequence[int] = 0) -> None:
        self.channel_dims = _as_tuple(channel_dim)

    def tile_size(self, data_shape: Sequence[int]) -> TileSize:
        tile = list(data_shape)
        for dim in self.channel_dims:
            tile[dim] = 1
        return tuple(tile)

    def repr_args(self) -> dict[str, Any]:
        dims = self.channel_dims
        return {"channel": dims[0] if len(dims) == 1 else dims}

    def _key(self) -> tuple[Any, ...]:
        return (self.channel_dims,)


@yamlable
class PerBlock(Granularity):
    """Blocked quantization: fixed-size blocks along ``block_dims``, optionally
    per-channel along ``per_channel_dims``.

    This is the granularity of per-group weight-only quantization (e.g. INT4
    g=128 uses ``PerBlock(block_dims=-1 (in-features dim), block_sizes=128,
    per_channel_dims=out-features dim)``).
    """

    def __init__(
        self,
        block_dims: int | Sequence[int],
        block_sizes: int | Sequence[int],
        per_channel_dims: int | Sequence[int] = (),
        strict_blocks: bool = True,
    ) -> None:
        self.block_dims = _as_tuple(block_dims)
        self.block_sizes = _as_tuple(block_sizes)
        self.per_channel_dims = _as_tuple(per_channel_dims)
        self.strict_blocks = strict_blocks

        if len(self.block_dims) != len(self.block_sizes):
            raise ValueError("block_sizes and block_dims must be of equal length")

    def tile_size(self, data_shape: Sequence[int]) -> TileSize:
        tile = list(data_shape)
        for dim in self.per_channel_dims:
            tile[dim] = 1
        for block_dim, block_size in zip(self.block_dims, self.block_sizes):
            if block_size > data_shape[block_dim]:
                raise ValueError(
                    f"Can't apply per-block quantization with block_size={block_size} over "
                    f"dimension {block_dim} of a tensor with shape {tuple(data_shape)}."
                )
            if self.strict_blocks and data_shape[block_dim] % block_size != 0:
                raise ValueError(
                    f"Block size {block_size} does not divide data dim "
                    f"{data_shape[block_dim]} at dimension {block_dim} exactly "
                    "(required because strict_blocks=True)."
                )
            tile[block_dim] = block_size
        return tuple(tile)

    def repr_args(self) -> dict[str, Any]:
        return {
            "block_dims": self.block_dims,
            "block_sizes": self.block_sizes,
            "per_channel_dims": self.per_channel_dims,
            "strict_blocks": self.strict_blocks,
        }

    def _key(self) -> tuple[Any, ...]:
        return (self.block_dims, self.block_sizes, self.per_channel_dims, self.strict_blocks)


@yamlable
class PerTile(Granularity):
    """Explicit tile shape."""

    def __init__(self, tile_shape: Sequence[int]) -> None:
        self.tile_shape = tuple(tile_shape)

    def tile_size(self, data_shape: Sequence[int]) -> TileSize:
        check_tile_compatibility(tuple(data_shape), self.tile_shape)
        return self.tile_shape

    def repr_args(self) -> dict[str, Any]:
        return {"tile_shape": self.tile_shape}

    def _key(self) -> tuple[Any, ...]:
        return (self.tile_shape,)


def is_per_tensor(granularity: Granularity) -> bool:
    return isinstance(granularity, PerTensor)


def is_per_channel(granularity: Granularity) -> bool:
    return isinstance(granularity, PerChannel)


def is_per_block(granularity: Granularity) -> bool:
    return isinstance(granularity, PerBlock)


def granularity_from_sizes(data_size: Sequence[int], tile_size: Sequence[int]) -> Granularity:
    """The simplest granularity with ``tile_size(data_size) == tile_size``."""
    data_size = tuple(data_size)
    tile_size = tuple(tile_size)
    if data_size == tile_size:
        return PerTensor()

    dims = range(len(data_size))
    divs = [d // t if t else 0 for d, t in zip(data_size, tile_size)]
    if all(
        div == 1 or div == data_dim for div, data_dim in zip(divs, data_size)
    ):
        indices = tuple(i for i in dims if tile_size[i] == 1 and data_size[i] > 1)
        return PerChannel(indices)

    block_dims = tuple(i for i in dims if tile_size[i] not in (1, data_size[i]))
    block_sizes = tuple(tile_size[i] for i in block_dims)
    per_channel_dims = tuple(i for i in dims if tile_size[i] == 1 and data_size[i] > 1)
    strict_blocks = all(d % t == 0 for d, t in zip(data_size, tile_size))
    return PerBlock(block_dims, block_sizes, per_channel_dims, strict_blocks=strict_blocks)
