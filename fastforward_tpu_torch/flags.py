"""The serving flags the port reads, with the JAX package's names, defaults
and parsing (`fastforward_tpu/flags.py`): an unset variable gives the
default, and the value ``"1"`` alone turns a flag on.

They select routes of the stacked decode step (`serving/stacked.py`),
read on every call of `serving_forward_stacked`:

- ``FF_FUSED_QKV`` (`fused_qkv`, off): the fused layer head, input RMSNorm
  + activation quantization + the qkv GEMV in one kernel;
- ``FF_FUSED_OGU`` (`fused_ogu`, off): o_proj + residual + RMSNorm +
  requantization + gate/up in one kernel where the fused tail is not taken;
- ``FF_FUSED_LAYER`` (`fused_layer`, on): the fused layer tail, o_proj
  through down_proj in one kernel, at up to 64 rows.
"""

import os


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw == "1"


def fused_qkv() -> bool:
    """The fused layer head in the stacked decode step (FF_FUSED_QKV)."""
    return _env_bool("FF_FUSED_QKV", False)


def fused_ogu() -> bool:
    """o_proj through gate/up in one kernel in the stacked decode step
    (FF_FUSED_OGU)."""
    return _env_bool("FF_FUSED_OGU", False)


def fused_layer() -> bool:
    """The fused layer tail in the stacked decode step (FF_FUSED_LAYER)."""
    return _env_bool("FF_FUSED_LAYER", True)
