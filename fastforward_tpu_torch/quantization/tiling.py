"""Tile layout utilities (`fastforward_tpu/quantization/tiling.py`).

Quantization math runs on the interleaved grid view ``(g0, t0, g1, t1,
...)`` of the data with the per-tile parameters reshaped to ``(g0, 1, g1,
1, ...)`` and broadcast: reshapes only, no transpose. ``tiles_to_rows`` /
``rows_to_tiles`` give the per-tile row form for code that wants it.

Tile-size convention: ``tile_size`` has the data's rank, every entry
divides the matching data dim, and one (scale, offset) pair is shared per
tile. Tiles are ordered row-major over the grid ``g_i = data_shape[i] //
tile_size[i]``; parameters are flat tensors of ``prod(g)`` elements in that
order.
"""

from typing import Literal, Sequence, Union

import torch

Shape = tuple
TileOrShape = Union[Sequence[int], Literal["data_shape"]]


def check_tile_compatibility(input_size: Sequence[int], tile_size: Sequence[int]) -> None:
    """Raise ValueError unless every tile dim divides the matching data dim
    (`tiling.py:29`)."""
    if len(input_size) != len(tile_size):
        raise ValueError(
            "Input dimensionality must match tile_size dimensionality, got "
            f"{len(input_size)} and {len(tile_size)}"
        )
    mismatched = [i for i, (d, t) in enumerate(zip(input_size, tile_size)) if t > 0 and d % t != 0]
    if mismatched:
        errors = [f"{input_size[i]} and {tile_size[i]} for dimension {i}" for i in mismatched]
        raise ValueError(
            "Each dimension of tile_size must divide the corresponding input dimension. Got "
            + ", ".join(errors) + "."
        )


def resolve_tile_size(tile_size: TileOrShape, data_shape: Sequence[int]) -> Shape:
    """Resolve the ``"data_shape"`` sentinel and validate compatibility."""
    if isinstance(tile_size, str) and tile_size == "data_shape":
        return tuple(data_shape)
    tile = tuple(int(t) for t in tile_size)
    check_tile_compatibility(tuple(data_shape), tile)
    return tile


def num_tiles(data_shape: Sequence[int], tile_size: TileOrShape) -> int:
    """Number of tiles (== number of parameter elements)."""
    n = 1
    for g in tile_grid(data_shape, tile_size):
        n *= g
    return n


def tile_grid(data_shape: Sequence[int], tile_size: TileOrShape) -> Shape:
    """Per-dimension tile counts ``g_i = data_shape[i] // tile_size[i]``."""
    tile = resolve_tile_size(tile_size, data_shape)
    return tuple(d // t for d, t in zip(data_shape, tile))


def interleaved_shape(data_shape: Sequence[int], tile_size: TileOrShape) -> Shape:
    """The grid/tile interleaved view shape ``(g0, t0, g1, t1, ...)``."""
    tile = resolve_tile_size(tile_size, data_shape)
    out = []
    for d, t in zip(data_shape, tile):
        out += [d // t, t]
    return tuple(out)


def tile_view(data: torch.Tensor, tile_size: TileOrShape) -> torch.Tensor:
    """``data`` in the interleaved grid/tile view (no transpose)."""
    return data.reshape(interleaved_shape(data.shape, tile_size))


def param_view(param: torch.Tensor, data_shape: Sequence[int],
               tile_size: TileOrShape) -> torch.Tensor:
    """A flat per-tile parameter reshaped to broadcast against
    ``tile_view(data)``: grid dims in place, tile dims 1."""
    shape = []
    for g in tile_grid(data_shape, tile_size):
        shape += [g, 1]
    return param.reshape(shape)


def apply_per_tile(fn, data: torch.Tensor, *params: torch.Tensor,
                   tile_size: TileOrShape) -> torch.Tensor:
    """``fn(tiled_data, *broadcast_params)`` in the interleaved view,
    reshaped back to ``data.shape``."""
    tiled = tile_view(data, tile_size)
    expanded = tuple(param_view(p, data.shape, tile_size) for p in params)
    return fn(tiled, *expanded).reshape(data.shape)


def _row_permutation(ndim2: int) -> list:
    # grid dims (even positions) first, then tile dims (odd positions)
    return list(range(0, ndim2, 2)) + list(range(1, ndim2, 2))


def tiles_to_rows(data: torch.Tensor, tile_size: TileOrShape) -> torch.Tensor:
    """Each tile as one row: ``(num_tiles, tile_elems)``, tiles row-major
    over the grid (`tiling.py:115`)."""
    if data.numel() == 0:
        return data.reshape(1, 0)
    tile = resolve_tile_size(tile_size, data.shape)
    tiled = tile_view(data, tile)
    return tiled.permute(_row_permutation(tiled.dim())).reshape(num_tiles(data.shape, tile), -1)


def rows_to_tiles(tiled_data: torch.Tensor, data_size: Sequence[int],
                  tile_size: TileOrShape) -> torch.Tensor:
    """Inverse of :func:`tiles_to_rows` (`tiling.py:131`)."""
    data_size = tuple(data_size)
    if tiled_data.numel() == 0:
        return tiled_data.reshape(data_size)
    tile = resolve_tile_size(tile_size, data_size)
    tile_elems = 1
    for t in tile:
        tile_elems *= t
    expected = (num_tiles(data_size, tile), tile_elems)
    if tuple(tiled_data.shape) != expected:
        raise ValueError(
            f"tiled_data is expected to be of size {expected} but found {tuple(tiled_data.shape)}"
        )
    inter = interleaved_shape(data_size, tile)
    perm = _row_permutation(len(inter))
    inverse = [0] * len(inter)
    for out_pos, in_pos in enumerate(perm):
        inverse[in_pos] = out_pos
    return tiled_data.reshape([inter[i] for i in perm]).permute(inverse).reshape(data_size)
