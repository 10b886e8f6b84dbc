"""Autoquant: op substitution at call time (`fastforward_tpu/autoquant.py`).

FastForward's autoquant rewrites model source so that every
``torch.relu(x)`` becomes ``ff.nn.functional.relu(x,
output_quantizer=self.q)``. Here, as in the JAX package, the same
capability is a runtime substitution context:

1. `quantize_model` swaps module classes (module-level substitution);
2. `autoquantize(model, sample_args)` runs one discovery forward with the
   torch functions of `SUBSTITUTABLE` *recording* their call sites,
   creates a quantizer slot per site on the model
   (``model.autoquant_quantizers``, an `nn.ModuleDict`), and gives the model
   a ``forward`` that runs inside the substitution context, where the i-th
   call of an op routes through `fastforward_tpu_torch.ops.<op>` with that
   site's quantizer as ``output_quantizer``.

Call sites are identified by (op, call index): the model's Python runs in
a fixed order, so a site's index is the same in discovery and apply.

**The interception is a `torch.overrides.TorchFunctionMode`**, where the
JAX package patches module attributes (``jax.nn.relu``). A mode sees every
call of a torch function object whatever name it is bound to, so a
reference bound before the context (``from torch.nn.functional import
gelu``) is intercepted without searching the model's modules for it, and
nothing is patched, so nothing has to be restored. The mode is off while
it handles a call, so a function's own inner calls (``F.relu`` calls
``torch.relu``) are not sites. It filters as the JAX wrapper does: only the
function objects of `SUBSTITUTABLE` and the rules' targets are sites, never
a `torch.Tensor` method or operator (``x @ w`` on plain tensors is no site,
as JAX's namespace patch never sees it), and calls made inside a quantized
operator (`ops.optable.IN_QUANTIZED_OP`) or inside a substituted call are
not recorded. Operator syntax on a `QuantizedTensor` operand is a site
through `operator_site`, which `QuantizedTensor`'s operators ask.
"""

import contextlib
import dataclasses
from contextvars import ContextVar
from typing import Any, Callable, Iterator, Optional, Sequence

import torch
from torch.overrides import TorchFunctionMode

from fastforward_tpu_torch import ops
from fastforward_tpu_torch.exceptions import QuantizationError
from fastforward_tpu_torch.nn.quantized_module import quantize_model
from fastforward_tpu_torch.nn.quantizer import QuantizerStub
from fastforward_tpu_torch.ops import optable

__all__ = ["AutoquantSiteMismatch", "PatternRule", "SUBSTITUTABLE", "DEFAULT_RULES",
           "autoquantize", "operator_site", "substitution"]


class AutoquantSiteMismatch(QuantizationError):
    """Raised when an apply-mode forward consumed a different set of call
    sites than the discovery forward recorded: data-dependent Python control
    flow changed the op-call count between record and apply (site indices
    would shift and quantizers be misassigned)."""


@dataclasses.dataclass(frozen=True)
class PatternRule:
    """A user-defined call-site rewrite rule, matched at interception: when
    ``target`` is called in an autoquant apply context (and ``predicate``
    passes), ``replacement`` runs instead of the default quantized op, with
    the original arguments and the site's ``output_quantizer``.

    target: qualified name of a torch function to intercept
        (``"torch.nn.functional.gelu"``) or the bare name of an operator
        autoquant already substitutes (``"gelu"``).
    replacement: ``fn(*args, output_quantizer=..., **kwargs)``.
    predicate: optional ``(args, kwargs) -> bool`` gate; unmatched calls
        take the default substitution.
    """

    target: str
    replacement: Callable[..., Any]
    predicate: Optional[Callable[..., bool]] = None

    @property
    def op_name(self) -> str:
        return self.target.rsplit(".", 1)[-1]

    def matches(self, args: tuple, kwargs: dict) -> bool:
        return self.predicate is None or bool(self.predicate(args, kwargs))


def _einsum_adapter(args, kwargs):
    # an einsum of more than two operands (or of an operand list) is no
    # quantized op: the None sentinel runs the original
    if len(args) > 3 or (len(args) == 2 and isinstance(args[1], (list, tuple))):
        return None
    return args, kwargs


# Ops whose torch entry points are substituted: operator name in the
# OPERATOR_TABLE -> (qualified names of the torch functions, args adapter
# or None). Keyword arguments the operator does not take are dropped where
# they are at their neutral value (`optable.operator_kwargs`), else the
# call runs unquantized.
SUBSTITUTABLE = {
    "relu": (("torch.relu", "torch.nn.functional.relu"), None),
    "silu": (("torch.nn.functional.silu",), None),
    "gelu": (("torch.nn.functional.gelu",), None),
    "sigmoid": (("torch.sigmoid", "torch.nn.functional.sigmoid"), None),
    "softmax": (("torch.softmax", "torch.nn.functional.softmax"), None),
    "log_softmax": (("torch.log_softmax", "torch.nn.functional.log_softmax"), None),
    "tanh": (("torch.tanh", "torch.nn.functional.tanh"), None),
    "matmul": (("torch.matmul",), None),
    "einsum": (("torch.einsum",), _einsum_adapter),
}


def _sdpa_replacement(query, key, value, attn_mask=None, dropout_p=0.0, is_causal=False,
                      scale=None, enable_gqa=False, *, output_quantizer=None):
    """`torch.nn.functional.scaled_dot_product_attention` through the
    quantizer-parameterized SDPA op (the same (..., T, D) layout)."""
    out = ops.scaled_dot_product_attention(
        query, key, value, attn_mask=attn_mask, dropout_p=dropout_p, is_causal=is_causal,
        scale=scale, enable_gqa=enable_gqa, strict_quantization=False,
    )
    if output_quantizer is not None:
        out = output_quantizer(out)
        out = out.dequantize() if hasattr(out, "dequantize") else out
    return out


# Always-on interception rules: ops whose torch entry points need argument
# mediation beyond an adapter. User rules (same target) match first.
DEFAULT_RULES = (
    PatternRule("torch.nn.functional.scaled_dot_product_attention", _sdpa_replacement),
)

_AUTO_CLASSES: dict[type, type] = {}

_MODE = ContextVar("autoquant_mode", default=None)  # None | "record" | "apply"
_SITES = ContextVar("autoquant_sites", default=None)
_COUNTS = ContextVar("autoquant_counts", default=None)
_INSIDE = ContextVar("autoquant_inside_op", default=False)
_RULES: ContextVar[tuple] = ContextVar("autoquant_rules", default=())


def _next_site(op_name: str) -> str:
    counts = _COUNTS.get()
    index = counts.get(op_name, 0)
    counts[op_name] = index + 1
    return f"{op_name}_{index}"


def _active() -> bool:
    return _MODE.get() is not None and not _INSIDE.get() and not optable.IN_QUANTIZED_OP.get()


class _SubstitutionMode(TorchFunctionMode):
    """Records or substitutes calls of ``targets`` (torch function object ->
    (operator name, adapter))."""

    def __init__(self, targets: dict):
        super().__init__()
        self.targets = targets

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        target = self.targets.get(func) if _active() else None
        if target is None:
            return func(*args, **kwargs)
        op_name, adapter = target
        site = _next_site(op_name)
        token = _INSIDE.set(True)
        try:
            if _MODE.get() == "record":
                _SITES.get().add(site)
                return func(*args, **kwargs)
            return self._apply(func, op_name, adapter, site, args, kwargs)
        finally:
            _INSIDE.reset(token)

    @staticmethod
    def _apply(func, op_name, adapter, site, args, kwargs):
        quantizer = _SITES.get().get(site)
        for rule in _RULES.get():
            if rule.op_name == op_name and rule.matches(args, kwargs):
                return rule.replacement(*args, output_quantizer=quantizer, **kwargs)
        spec = optable.get_operator(op_name)
        if spec is None:
            # intercepted only for a PatternRule and no rule matched
            return func(*args, **kwargs)
        if adapter is not None:
            adapted = adapter(args, kwargs)
            if adapted is None:  # no quantized op computes this form
                return func(*args, **kwargs)
            args, kwargs = adapted
        op_kwargs = optable.operator_kwargs(spec, kwargs)
        if op_kwargs is None:
            return func(*args, **kwargs)
        return spec.wrapper(*args, output_quantizer=quantizer, **op_kwargs)


def operator_site(op_name: str):
    """The hook of `QuantizedTensor`'s operators (``x + y``, ``x @ y``):
    inside an autoquant context, operator syntax on a QuantizedTensor operand
    is a call site like any intercepted function, recorded in discovery and
    given the site's output quantizer in apply mode. Returns
    (output_quantizer or None, active)."""
    if not _active():
        return None, False
    site = _next_site(op_name)
    if _MODE.get() == "record":
        _SITES.get().add(site)
        return None, False
    return _SITES.get().get(site), True


def _targets(rules: Sequence[PatternRule]) -> dict:
    """torch function object -> (operator name, adapter) for the
    substitutable ops and the rules' qualified targets."""
    out = {}
    for op_name, (names, adapter) in SUBSTITUTABLE.items():
        for name in names:
            fn = optable._resolve_qualified(name)
            if fn is not None:
                out[fn] = (op_name, adapter)
    for rule in rules:
        if "." in rule.target:
            fn = optable._resolve_qualified(rule.target)
            if fn is None:
                raise ValueError(f"PatternRule target {rule.target!r} names no function")
            out.setdefault(fn, (rule.op_name, None))
    return out


@contextlib.contextmanager
def substitution(model: Any, mode: str, rules: Sequence[PatternRule] = ()) -> Iterator[Any]:
    """Activate op substitution for ``model``'s autoquant sites."""
    if mode == "record":
        sites: Any = set()
    else:
        holder = getattr(model, "autoquant_quantizers", None)
        sites = dict(holder.items()) if holder is not None else {}
    if not rules:
        rules = tuple(getattr(model, "_autoquant_rules", ()))
    rules = tuple(rules) + DEFAULT_RULES
    counts: dict[str, int] = {}
    tokens = (_MODE.set(mode), _SITES.set(sites), _COUNTS.set(counts), _RULES.set(rules))
    try:
        with _SubstitutionMode(_targets(rules)):
            yield sites
    finally:
        for var, token in zip((_MODE, _SITES, _COUNTS, _RULES), tokens):
            var.reset(token)
    if mode == "record":  # for the strictness check of the apply forwards
        model._autoquant_expected_counts = dict(counts)


def _check_site_counts(model: Any, observed: dict) -> None:
    expected = getattr(model, "_autoquant_expected_counts", None)
    if expected is None or not getattr(model, "_autoquant_strict_sites", True):
        return
    if dict(observed) == dict(expected):
        return
    lines = []
    for op in sorted(set(expected) | set(observed)):
        e, o = expected.get(op, 0), observed.get(op, 0)
        if e != o:
            lines.append(f"  {op}: recorded {e}, observed {o}")
    raise AutoquantSiteMismatch(
        "autoquant call-site mismatch between discovery and apply "
        "forwards:\n" + "\n".join(lines) + "\n"
        "Likely causes: data-dependent Python control flow changed which "
        "ops run (site quantizers would be silently misassigned), or a "
        "function was re-bound between forwards. Re-run autoquantize() on "
        "representative inputs, or set model._autoquant_strict_sites = False "
        "to accept per-forward site assignment."
    )


def autoquantize(
    model: torch.nn.Module,
    *sample_args: Any,
    convert_modules: bool = True,
    replacement_patterns: Sequence[PatternRule] = (),
    strict_sites: bool = True,
    **sample_kwargs: Any,
) -> torch.nn.Module:
    """Quantize ``model`` including function-level op calls.

    After this call every known op called in the model's forward has a
    quantizer slot (``model.autoquant_quantizers["relu_0"]``, ...) that
    `QuantizationConfig` rules address with ``"autoquant_quantizers/*"``,
    and the model's ``forward`` runs under the substitution context.
    """
    from fastforward_tpu_torch import flags

    if convert_modules:
        quantize_model(model)

    model._autoquant_rules = tuple(replacement_patterns)
    model._autoquant_strict_sites = strict_sites

    with flags.strict_quantization(False), torch.no_grad():
        with substitution(model, "record", rules=replacement_patterns) as sites:
            model(*sample_args, **sample_kwargs)

    model.autoquant_quantizers = torch.nn.ModuleDict(
        {site: QuantizerStub("activation/autoquant") for site in sorted(sites)})

    # A forward that always runs under the substitution context. The
    # AutoQuant subclass is made once per original class (two models of one
    # class share it; calling autoquantize again on a model changes nothing).
    cls = type(model)
    if not getattr(cls, "_autoquant_call_installed", False):
        auto_cls = _AUTO_CLASSES.get(cls)
        if auto_cls is None:
            original_forward = cls.forward

            def forward_with_substitution(self, *args: Any, **kwargs: Any):
                if _MODE.get() is not None:
                    return original_forward(self, *args, **kwargs)
                with substitution(self, "apply"):
                    out = original_forward(self, *args, **kwargs)
                    observed = dict(_COUNTS.get())
                _check_site_counts(self, observed)
                return out

            auto_cls = type(f"AutoQuant{cls.__name__}", (cls,), {
                "forward": forward_with_substitution, "_autoquant_call_installed": True})
            _AUTO_CLASSES[cls] = auto_cls
        model.__class__ = auto_cls
    return model
