"""INT8 KV quantization, ported from `fastforward_tpu/serving/kv_cache.py:21-29`."""

import torch

NEG_INF = -1e30


def _quantize_kv(x: torch.Tensor):
    """Symmetric per-(batch, head, token) int8 quantization of (B, H, T, D):
    returns (int8 values, f32 scales (B, H, T))."""
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    # XLA compiles the division by 127 inside jit to this multiply by the
    # float32 reciprocal; written out so the scales agree bit for bit.
    scale = torch.clamp(amax * (1.0 / 127.0), min=1e-8)
    q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return q, scale.squeeze(-1)
