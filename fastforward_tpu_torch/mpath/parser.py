"""mpath query-string parser (`fastforward_tpu/mpath/parser.py`).

Grammar (one selector per string; Python-level ``&`` / ``|`` compose
selectors):

    query     := segment ("/" segment)*
    segment   := "~"? atom ("&" atom)* | atom ("|" atom)*
    atom      := "**" | "*" | name | bracket
    bracket   := "[" kind ":" payload "]"
    kind      := "cls" | "re" | "quantizer" | a registered extension

Class resolution for ``[cls:...]``: an explicit context dict, then the
default registry: the classes of `torch.nn` and of the port's `nn` by
simple name, and the NNX names the JAX package's queries use where
torch's differ (`NNX_ALIASES`: ``Embed`` is `torch.nn.Embedding`, ``Conv``
any of ``Conv1d``-``Conv3d``, ...), then a dotted name imported from its
module.
"""

import re
from typing import Any, Optional

from fastforward_tpu_torch.mpath.fragments import (
    ClassFragment,
    DisjointFragment,
    Fragment,
    JointFragment,
    NameFragment,
    QuantizerTagFragment,
    RegexFragment,
    WildcardFragment,
)
from fastforward_tpu_torch.mpath.selector import Selector

# NNX (and the JAX package's nn) class names whose torch counterpart has
# another name, or is several classes (one per rank)
NNX_ALIASES = {
    "Embed": ("Embedding",),
    "Conv": ("Conv1d", "Conv2d", "Conv3d"),
    "ConvTranspose": ("ConvTranspose1d", "ConvTranspose2d", "ConvTranspose3d"),
    "BatchNorm": ("BatchNorm1d", "BatchNorm2d", "BatchNorm3d"),
    "InstanceNorm": ("InstanceNorm1d", "InstanceNorm2d", "InstanceNorm3d"),
    "MultiHeadAttention": ("MultiheadAttention",),
    "QuantizedConv": ("QuantizedConv1d", "QuantizedConv2d", "QuantizedConv3d"),
}


def _default_context() -> dict[str, Any]:
    import torch

    import fastforward_tpu_torch.nn as ffnn

    ctx: dict[str, Any] = {}
    for mod in (torch.nn, ffnn):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type):
                ctx.setdefault(name, obj)
    for alias, names in NNX_ALIASES.items():
        classes = tuple(ctx[n] for n in names)
        ctx.setdefault(alias, classes[0] if len(classes) == 1 else classes)
    ctx["ff.nn.Quantizer"] = ffnn.Quantizer
    ctx["Quantizer"] = ffnn.Quantizer
    return ctx


_DEFAULT_CONTEXT: Optional[dict[str, Any]] = None


def _resolve_class(name: str, context: Optional[dict[str, Any]]):
    global _DEFAULT_CONTEXT
    if context and name in context:
        return context[name]
    if _DEFAULT_CONTEXT is None:
        _DEFAULT_CONTEXT = _default_context()
    if name in _DEFAULT_CONTEXT:
        return _DEFAULT_CONTEXT[name]
    # Qualified name: import the module path.
    if "." in name:
        mod_name, _, cls_name = name.rpartition(".")
        try:
            import importlib

            mod = importlib.import_module(mod_name)
            obj = getattr(mod, cls_name)
            if isinstance(obj, type):
                return obj
        except (ImportError, AttributeError):
            pass
    raise ValueError(
        f"Cannot resolve class {name!r} in [cls:...] fragment; pass it via "
        "the context= argument of mpath.query."
    )


# --- query extensions ---------------------------------------------------
# User-registered bracket kinds (`[mykind:payload]`) resolving to custom
# fragments. The factory receives (payload, context) and returns a Fragment.
_EXTENSIONS: dict[str, Any] = {}


def mpath_query_extension(kind: str):
    """Register a custom ``[kind:payload]`` fragment factory (decorator)."""

    def decorator(factory):
        _EXTENSIONS[kind] = factory
        return factory

    return decorator


_SEGMENT_SPLIT = re.compile(r"/(?![^\[]*\])")  # "/" outside brackets


def _split_ops(segment: str, op: str) -> list[str]:
    """Split on an operator char at bracket depth zero."""
    parts, depth, current = [], 0, []
    for ch in segment:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == op and depth == 0:
            parts.append("".join(current))
            current = []
        else:
            current.append(ch)
    parts.append("".join(current))
    return parts


def _parse_atom(atom: str, context: Optional[dict[str, Any]]) -> Fragment:
    atom = atom.strip()
    if atom == "**":
        return WildcardFragment(multi=True)
    if atom == "*":
        return WildcardFragment(multi=False)
    if atom.startswith("[") and atom.endswith("]"):
        body = atom[1:-1]
        kind, sep, payload = body.partition(":")
        if not sep:
            raise ValueError(f"Malformed bracket fragment: {atom!r}")
        kind = kind.strip()
        payload = payload.strip()
        if kind == "cls":
            return ClassFragment(_resolve_class(payload, context), payload)
        if kind == "re":
            return RegexFragment(payload)
        if kind == "quantizer":
            return QuantizerTagFragment(payload)
        if kind in _EXTENSIONS:
            return _EXTENSIONS[kind](payload, context)
        raise ValueError(f"Unknown fragment kind {kind!r} in {atom!r}")
    if not re.fullmatch(r"[\w.\-]+", atom):
        raise ValueError(f"Invalid path segment: {atom!r}")
    return NameFragment(atom)


def _parse_segment(segment: str, context: Optional[dict[str, Any]]) -> Fragment:
    segment = segment.strip()
    negate = False
    if segment.startswith("~"):
        negate = True
        segment = segment[1:].strip()

    or_parts = _split_ops(segment, "|")
    if len(or_parts) > 1:
        frag: Fragment = DisjointFragment(
            *(_parse_segment(p, context) for p in or_parts)
        )
    else:
        and_parts = _split_ops(segment, "&")
        if len(and_parts) > 1:
            frag = JointFragment(*(_parse_atom(p, context) for p in and_parts))
        else:
            frag = _parse_atom(segment, context)
    return ~frag if negate else frag


def parse(query: str, context: Optional[dict[str, Any]] = None) -> Selector:
    query = query.strip()
    if not query:
        raise ValueError("Empty mpath query")
    segments = [s for s in _SEGMENT_SPLIT.split(query) if s != ""]
    return Selector([_parse_segment(s, context) for s in segments])
