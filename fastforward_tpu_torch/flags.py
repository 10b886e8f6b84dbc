"""The port's flags (`fastforward_tpu/flags.py`).

Context flags (`flags.py:23-86`): a (getter, setter, context manager)
triple each, backed by a `contextvars.ContextVar`, and the `context`
decorator that runs a function under one of them:

- ``strict_quantization`` (on): an operator refuses a quantized input it
  would silently dequantize, and a `QuantizedTensor` refuses implicit
  conversion (`quantization/quantized_array.py`);
- ``export_mode`` (off): quantizers return quantize-dequantized plain
  tensors in place of `QuantizedTensor`s;
- ``use_kernels`` (on): declared as the JAX package declares it, to let
  quantized operators dispatch to the low-bit kernels; no code of either
  package reads it (the dispatcher sends a matching call to its kernel
  whatever its value).

The serving flags the port reads, with the JAX package's names, defaults
and parsing: an unset variable gives the
default, the value ``"1"`` alone turns a boolean flag on, and an integer
flag is ``int`` of its value.

Routes of the stacked decode step (`serving/stacked.py`), read on every
call of `serving_forward_stacked`:

- ``FF_FUSED_QKV`` (`fused_qkv`, off): the fused layer head, input RMSNorm
  + activation quantization + the qkv GEMV in one kernel;
- ``FF_FUSED_OGU`` (`fused_ogu`, off): o_proj + residual + RMSNorm +
  requantization + gate/up in one kernel where the fused tail is not taken;
- ``FF_FUSED_LAYER`` (`fused_layer`, on): the fused layer tail, o_proj
  through down_proj in one kernel, at up to 64 rows.

The at-rest layout of the fused paired W4A8 weights, read at
`fuse_stacked_layers` time:

- ``FF_2L_PREBLOCK`` (`two_level_preblock`, off): packed weights
  (L, K/2, N) become (L, N/bn, K/2, bn), one contiguous panel per bn
  columns, where N % bn == 0;
- ``FF_2L_BLOCK_N`` (`two_level_block_n`, 512): that panel width bn.

Routes of the stacked W4A8 GEMV (`kernels/matmul.py`), read at each call:

- ``FF_2L_MANUAL`` (`two_level_manual_bufs`, 0): at 2 or more, pre-blocked
  weights stream through a ring of that many shared-memory stages;
- ``FF_2L_SPLITW`` (`two_level_split_w`, off): flat weights read as two
  half-K streams;
- ``FF_2L_DOTRAW`` (`two_level_dotraw`, off): either layout, the raw
  nibbles dotted per group and the multiplier applied to the group's sum;
- ``FF_2L_CONCAT_PAIRS`` (`two_level_concat_pairs`, 1): above 1, either
  layout walks that many adjacent group pairs as one unit.

The greedy head of `make_stacked_decode_loop`, read when the loop is made:

- ``FF_FUSED_ARGMAX`` (`fused_argmax`, on): the fused GEMV + argmax
  lm_head, else f32 logits and their argmax.

The KV-cache flow and the attention of both forwards (`serving/stacked.py`
`attention_route`), read on every forward call; a string flag is the
variable's value as it stands:

- ``FF_KV_STACKED`` (`kv_stacked_mode`, "1"): "1" and "force" (the port
  reads the JAX package's TPU test as true, so the two are one) take the
  stacked decode step, the stacked append and `flash_decode_select`; any
  other value the slab flow, a layer's own append and flash decode
  (`flash_decode_int8`), dense attention below 2 query heads per kv head;
- ``FF_KV_WRITE`` (`kv_write_mode`, "kernel"): the slab flow's one-token
  append, "kernel" the per-layer append kernel, "mask" a select over the
  cache's S rows in plain torch, any other value a per-row write in plain
  torch; another value than "kernel" also leaves the stacked step;
- ``FF_PREFILL_STACKED`` (`prefill_stacked`, on): the int8 prefill writes
  a layer's block at once; off, row by row (the slab flow's write; the
  same bytes);
- ``FF_BENCH_FLASH`` (`use_flash_attention`, on): off, a one-token step
  attends densely over the dequantized cache, and the stacked forward
  leaves the stacked step;
- ``FF_FLASH_PREFILL`` (`use_flash_prefill`, on): off, a prefill attends
  densely (masked grouped attention over the dequantized int8 or the bf16
  cache) in place of `flash_prefill`.

The at-rest layout of newly packed two-level W4A8 weights, read at pack
time (`kernels/matmul.py` `convert_two_level` and the ``paired=None``
defaults of the two-level GEMV wrappers, `serving/engine.py`
`quantize_linear`, `serving/stacked.py` `random_stacked_params`):

- ``FF_2L_PAIRED`` (`default_paired_layout`, on): an even group count
  packs adjacent groups in pairs; off, every count takes the group-halves
  layout. The decode follows the layout the weights carry (``paired``).
"""

import contextlib
import functools
import os
from contextvars import ContextVar
from typing import Any, Callable, Iterator

_FLAGS: dict = {}


def _context_flag(name: str, default: bool):
    """A (getter, setter, context manager) triple for a boolean flag
    (`flags.py:23`)."""
    var: ContextVar = ContextVar(name, default=default)
    _FLAGS[name] = var

    def getter() -> bool:
        return var.get()

    def setter(value: bool) -> None:
        var.set(bool(value))

    @contextlib.contextmanager
    def manager(value: bool = True) -> Iterator[None]:
        token = var.set(bool(value))
        try:
            yield
        finally:
            var.reset(token)

    getter.__name__ = f"get_{name}"
    setter.__name__ = f"set_{name}"
    manager.__name__ = name
    return getter, setter, manager


def context(flag_manager: Callable[[bool], Any], value: bool = True) -> Callable[..., Any]:
    """Decorator running the wrapped function under ``flag_manager(value)``
    (`flags.py:53`)."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with flag_manager(value):
                return func(*args, **kwargs)

        return wrapper

    return decorator


get_strict_quantization, set_strict_quantization, strict_quantization = _context_flag(
    "strict_quantization", default=True)
get_export_mode, set_export_mode, export_mode = _context_flag("export_mode", default=False)
get_use_kernels, set_use_kernels, use_kernels = _context_flag("use_kernels", default=True)


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw == "1"


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw is None else int(raw)


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


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


def fused_argmax() -> bool:
    """The fused GEMV + argmax lm_head of the greedy stacked decode loop
    (FF_FUSED_ARGMAX)."""
    return _env_bool("FF_FUSED_ARGMAX", True)


def two_level_preblock() -> bool:
    """Pre-blocked stacked paired W4A8 weights (L, N/bn, K/2, bn), applied
    at fuse time (FF_2L_PREBLOCK)."""
    return _env_bool("FF_2L_PREBLOCK", False)


def two_level_block_n() -> int:
    """Panel width bn of the pre-blocked layout (FF_2L_BLOCK_N)."""
    return _env_int("FF_2L_BLOCK_N", 512)


def two_level_manual_bufs() -> int:
    """Stages of the manual weight stream of the stacked W4A8 GEMV over
    pre-blocked weights; below 2, off (FF_2L_MANUAL)."""
    return _env_int("FF_2L_MANUAL", 0)


def two_level_split_w() -> bool:
    """The stacked W4A8 GEMV reads flat weights as two half-K streams
    (FF_2L_SPLITW)."""
    return _env_bool("FF_2L_SPLITW", False)


def two_level_dotraw() -> bool:
    """The stacked W4A8 GEMV dots the raw nibbles and applies each group's
    multiplier to its sum (FF_2L_DOTRAW)."""
    return _env_bool("FF_2L_DOTRAW", False)


def two_level_concat_pairs() -> int:
    """Adjacent group pairs one unit of the stacked W4A8 GEMV walks; 1 (the
    default) or less, one pair (FF_2L_CONCAT_PAIRS)."""
    return _env_int("FF_2L_CONCAT_PAIRS", 1)


def kv_write_mode() -> str:
    """The slab flow's one-token KV append: kernel | mask | scatter
    (FF_KV_WRITE); a value other than "kernel" or "mask" is the scatter."""
    return _env_str("FF_KV_WRITE", "kernel")


def kv_stacked_mode() -> str:
    """The stacked decode step's KV flow: 1 | 0 | force (FF_KV_STACKED)."""
    return _env_str("FF_KV_STACKED", "1")


def prefill_stacked() -> bool:
    """The int8 prefill writes a layer's block at once, else row by row
    (FF_PREFILL_STACKED)."""
    return _env_bool("FF_PREFILL_STACKED", True)


def use_flash_attention() -> bool:
    """Flash decode, else dense attention over the dequantized cache
    (FF_BENCH_FLASH)."""
    return _env_bool("FF_BENCH_FLASH", True)


def use_flash_prefill() -> bool:
    """Flash prefill, else dense masked attention (FF_FLASH_PREFILL)."""
    return _env_bool("FF_FLASH_PREFILL", True)


def default_paired_layout() -> bool:
    """Pack-time layout of two-level W4A8 weights: adjacent-group pairs
    where the group count is even, else group halves (FF_2L_PAIRED)."""
    return _env_bool("FF_2L_PAIRED", True)
