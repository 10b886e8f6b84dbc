"""GPTQ: layer-local weight quantization with Hessian-aware error feedback
(`fastforward_tpu/algorithms/gptq.py`).

Min-max init of the weight grid, the Hessian of the calibration
activations, the upper Cholesky factor of its dampened inverse, and a
blocked column loop with error feedback and optional activation ordering.

Weight layout is torch's (out_features, in_features): the columns the loop
walks are the in-features, dim 1 (the JAX package's layout is (in, out)
and walks rows). A granularity is given on this layout: the JAX package's
``PerChannel(1)`` (one scale per output channel) is ``PerChannel(0)``
here, its ``PerBlock(0, g, 1)`` is ``PerBlock(1, g, 0)``
(`nn.convert.transpose_granularity`).

Precision: the Hessian, the inversion and the trailing updates run in f32
with TF32 off (the JAX package pins "highest" precision; reduced-precision
products there degraded GPTQ), set for the call and restored after it.
The column loop is a Python loop over a block's columns (one column's
quantization and its rank-1 update of the block's later columns a step),
then one product updates every column after the block.
"""

import contextlib
from typing import Optional

import torch

from fastforward_tpu_torch.quantization import affine, tiling
from fastforward_tpu_torch.quantization.granularity import (
    Granularity,
    PerBlock,
    PerChannel,
    PerTensor,
)


@contextlib.contextmanager
def full_f32_precision():
    """f32 products without TF32 (cuBLAS and cuDNN) inside the context;
    the previous settings restored on leaving it."""
    saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]


def calculate_hessian(inputs: torch.Tensor) -> torch.Tensor:
    """H = 2/n · Xᵀ X over flattened calibration activations (…, in_features), f32."""
    x = inputs.reshape(-1, inputs.shape[-1]).float()
    n = x.shape[0]
    with full_f32_precision():
        return (2.0 / n) * torch.matmul(x.T, x)


def invert_hessian(hessian: torch.Tensor, perc_damp: float = 0.01) -> torch.Tensor:
    """Dampened inverse via Cholesky; returns the *upper Cholesky factor of
    the inverse* (the form the column loop consumes). A dead input (zero
    diagonal) gets a unit diagonal."""
    diag = torch.diagonal(hessian)
    damp = perc_damp * torch.mean(diag)
    h = hessian.float().clone()
    h.diagonal().copy_(torch.where(diag > 0, diag + damp, torch.ones_like(diag)))
    with full_f32_precision():
        hinv = torch.linalg.inv(h)
        chol = torch.linalg.cholesky(hinv)  # lower
    return chol.T.contiguous()  # upper


def _column_scales(out_features: int, in_features: int, scale: torch.Tensor,
                   granularity: Granularity) -> torch.Tensor:
    """Expand quantizer scales to a dense (out, in) map, so that each
    column's grid is a lookup."""
    scale = scale.float().reshape(-1)
    shape = (out_features, in_features)
    if isinstance(granularity, PerTensor):
        return scale.reshape(1, 1).expand(shape)
    if isinstance(granularity, PerChannel):
        dims = granularity.channel_dims
        if dims == (0,):
            return scale.reshape(out_features, 1).expand(shape)
        if dims == (1,):
            return scale.reshape(1, in_features).expand(shape)
        raise ValueError(f"Unsupported PerChannel dims for GPTQ: {dims}")
    if isinstance(granularity, PerBlock):
        tile = granularity.tile_size(shape)
        grid = scale.reshape(out_features // tile[0], in_features // tile[1])
        return grid.repeat_interleave(tile[0], dim=0).repeat_interleave(tile[1], dim=1)
    raise ValueError(f"Unsupported granularity for GPTQ: {granularity}")


def _gptq_core(w: torch.Tensor, hinv_u: torch.Tensor, scales: torch.Tensor, num_bits: float,
               block_size: int):
    """Blocked GPTQ update.

    w: (out, in) f32; hinv_u: (in, in) upper Cholesky factor of H⁻¹;
    scales: (out, in) per-element scale (symmetric grid). Returns (q, the
    grid values as f32, and w_dq, the dequantized weights), both (out, in).
    """
    in_features = w.shape[1]
    qmin, qmax = affine.integer_minimum(num_bits), affine.integer_maximum(num_bits)
    w = w.float().clone()
    with full_f32_precision():
        for start in range(0, in_features, block_size):
            end = start + block_size
            wb = w[:, start:end]  # a view: the loop updates w in place
            sb = scales[:, start:end]
            hb = hinv_u[start:end, start:end]
            errb = torch.empty_like(wb)
            for i in range(block_size):
                w_col, s_col, err = wb[:, i], sb[:, i], errb[:, i]
                dq = torch.div(w_col, s_col).round_().clamp_(qmin, qmax).mul_(s_col)
                torch.sub(w_col, dq, out=err)
                err.div_(hb[i, i])
                w_col.copy_(dq)
                # error feedback within the block: columns i+1.. get -err * hb[i, j]
                wb[:, i + 1:].addr_(err, hb[i, i + 1:], alpha=-1.0)
            # lazy trailing update of every column after the block: one product
            if end < in_features:
                w[:, end:] -= torch.matmul(errb, hinv_u[start:end, end:])
    # the grid values: each dequantized column divided by its scale rounds
    # back to its integer exactly (|q| <= 2^(b-1), one rounding of q * s)
    q = torch.round(w / scales)
    return q, w


def gptq_quantize(
    weight: torch.Tensor,
    inputs: torch.Tensor,
    *,
    num_bits: int = 4,
    granularity: Optional[Granularity] = None,
    block_size: int = 128,
    perc_damp: float = 0.01,
    act_order: bool = False,
    hessian: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GPTQ-quantize an (out, in) weight given calibration ``inputs``
    (…, in) on the weight's device.

    Returns ``(q_grid, w_dq, scales_expanded)``: integer grid values (f32),
    the dequantized weight to install (in the weight's dtype), and the
    per-element (out, in) scale map. Scales come from symmetric min-max over
    the weight at ``granularity`` (default ``PerChannel(0)``, one per output
    channel).
    """
    out_features, in_features = weight.shape
    granularity = granularity or PerChannel(0)
    w = weight.detach().float()
    inputs = inputs.to(w.device)

    tile = tiling.resolve_tile_size(granularity.tile_size(tuple(w.shape)), tuple(w.shape))
    tiled = w.reshape(tiling.interleaved_shape(tuple(w.shape), tile))
    axes = tuple(range(1, tiled.dim(), 2))
    mn = torch.amin(tiled, dim=axes).reshape(-1)
    mx = torch.amax(tiled, dim=axes).reshape(-1)
    scale, _ = affine.parameters_for_range(mn, mx, num_bits, symmetric=True,
                                           allow_one_sided=False)
    scales = _column_scales(out_features, in_features, scale, granularity)

    H = hessian.to(w.device) if hessian is not None else calculate_hessian(inputs)

    perm = None
    if act_order:
        # process the high-activation columns first
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        inv_perm = torch.argsort(perm, stable=True)
        H = H[perm][:, perm]
        w = w[:, perm]
        scales = scales[:, perm]

    hinv_u = invert_hessian(H, perc_damp)

    if in_features % block_size != 0:
        block_size = in_features
    q, w_dq = _gptq_core(w, hinv_u, scales, float(num_bits), block_size)

    if perm is not None:
        q = q[:, inv_perm]
        w_dq = w_dq[:, inv_perm]
        scales = scales[:, inv_perm]
    return q, w_dq.to(weight.dtype), scales


@torch.no_grad()
def gptq(
    module,
    inputs: torch.Tensor,
    *,
    num_bits: int = 4,
    granularity: Optional[Granularity] = None,
    block_size: int = 128,
    perc_damp: float = 0.01,
    act_order: bool = False,
) -> None:
    """Apply GPTQ to a (Quantized) `torch.nn.Linear` in place.

    The module's weight is overwritten with the GPTQ-optimized dequantized
    weights, and its weight quantizer (a `LinearQuantizer`, or a new one in
    place of a stub) gets the matching grid, so that its fake quantization
    reproduces the same grid.
    """
    from fastforward_tpu_torch.nn.linear_quantizer import LinearQuantizer

    granularity = granularity or PerChannel(0)
    weight = module.weight
    q, w_dq, scales = gptq_quantize(
        weight, inputs, num_bits=num_bits, granularity=granularity,
        block_size=block_size, perc_damp=perc_damp, act_order=act_order,
    )
    weight.copy_(w_dq)

    wq = getattr(module, "weight_quantizer", None)
    if isinstance(wq, LinearQuantizer) or (
        wq is not None and hasattr(wq, "quantization_range") and not wq.is_stub
    ):
        _install_range(wq, tuple(weight.shape), granularity, scales, num_bits)
    elif wq is not None and getattr(wq, "is_stub", False):
        new_q = LinearQuantizer(
            num_bits=num_bits, granularity=granularity, symmetric=True,
            allow_one_sided=False,
        )
        _install_range(new_q, tuple(weight.shape), granularity, scales, num_bits)
        module.weight_quantizer = new_q


def _install_range(quantizer, w_shape, granularity, scales, num_bits):
    tile = tiling.resolve_tile_size(granularity.tile_size(w_shape), w_shape)
    # collapse the expanded (out, in) scale map back to one scale per tile
    grid = (w_shape[0] // tile[0], w_shape[1] // tile[1])
    per_tile = scales.reshape(grid[0], tile[0], grid[1], tile[1])[:, 0, :, 0].reshape(-1)
    quantizer.granularity = granularity
    quantizer.num_bits = num_bits
    mn, mx = affine.quantization_range(per_tile, None, num_bits)
    quantizer.quantization_range = (mn, mx)
