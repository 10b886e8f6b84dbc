"""Query fragments: the per-segment building blocks of mpath selectors
(`fastforward_tpu/mpath/fragments.py`).

A fragment matches one path segment given the module at that segment:
names, ``*`` / ``**`` wildcards, ``[cls:...]``, ``[re:...]``,
``[quantizer:...]``, predicates, and their negation, joint (``&``) and
disjoint (``|``) forms.
"""

import re
from typing import Any, Callable, Optional, Union


class Fragment:
    """Matches (or not) one path segment given the module at that segment."""

    #: True for fragments that may match a variable number of segments.
    is_multi = False

    def matches(self, segment: str, module: Any) -> bool:
        raise NotImplementedError

    def __invert__(self) -> "Fragment":
        return NegatedFragment(self)

    def __and__(self, other: "Fragment") -> "Fragment":
        return JointFragment(self, other)

    def __or__(self, other: "Fragment") -> "Fragment":
        return DisjointFragment(self, other)


class NameFragment(Fragment):
    def __init__(self, name: str):
        self.name = name

    def matches(self, segment: str, module: Any) -> bool:
        return segment == self.name

    def __repr__(self) -> str:
        return self.name


class WildcardFragment(Fragment):
    """``*`` (one segment) or ``**`` (any number of segments)."""

    def __init__(self, multi: bool = False):
        self.is_multi = multi

    def matches(self, segment: str, module: Any) -> bool:
        return True

    def __repr__(self) -> str:
        return "**" if self.is_multi else "*"


class ClassFragment(Fragment):
    """``[cls:SomeClass]`` — module is an instance of the class (or of one
    of a tuple of classes, as an NNX name that stands for several torch
    classes resolves: ``Conv`` is ``Conv1d``, ``Conv2d`` and ``Conv3d``)."""

    def __init__(self, cls: Union[type, tuple], name: Optional[str] = None):
        self.cls = cls
        self.name = name or getattr(cls, "__name__", repr(cls))

    def matches(self, segment: str, module: Any) -> bool:
        return isinstance(module, self.cls)

    def __repr__(self) -> str:
        return f"[cls:{self.name}]"


class RegexFragment(Fragment):
    def __init__(self, pattern: str):
        self.pattern = re.compile(pattern)

    def matches(self, segment: str, module: Any) -> bool:
        return self.pattern.fullmatch(segment) is not None

    def __repr__(self) -> str:
        return f"[re:{self.pattern.pattern}]"


class QuantizerTagFragment(Fragment):
    """``[quantizer:tag]`` — module is a `Quantizer` (a stub or a real
    one) whose ``quant_metadata`` carries the tag or one below it; ``""``
    and ``"*"`` match every quantizer."""

    def __init__(self, tag: str):
        self.tag = tag

    def matches(self, segment: str, module: Any) -> bool:
        from fastforward_tpu_torch.nn.quantizer import Quantizer

        if not isinstance(module, Quantizer):
            return False
        if self.tag in ("", "*"):
            return True
        metadata = getattr(module, "quant_metadata", None)
        if metadata is None:
            return False
        return metadata.matches_tag(self.tag)

    def __repr__(self) -> str:
        return f"[quantizer:{self.tag}]"


class PredicateFragment(Fragment):
    """Arbitrary predicate over (segment, module)."""

    def __init__(self, fn: Callable[[str, Any], bool], name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "predicate")

    def matches(self, segment: str, module: Any) -> bool:
        return bool(self.fn(segment, module))

    def __repr__(self) -> str:
        return f"[pred:{self.name}]"


class NegatedFragment(Fragment):
    def __init__(self, inner: Fragment):
        self.inner = inner

    def matches(self, segment: str, module: Any) -> bool:
        return not self.inner.matches(segment, module)

    def __repr__(self) -> str:
        return f"~{self.inner!r}"


class JointFragment(Fragment):
    """Both fragments must match the same segment (``&``)."""

    def __init__(self, *fragments: Fragment):
        self.fragments = fragments

    def matches(self, segment: str, module: Any) -> bool:
        return all(f.matches(segment, module) for f in self.fragments)

    def __repr__(self) -> str:
        return "&".join(repr(f) for f in self.fragments)


class DisjointFragment(Fragment):
    """Either fragment may match (``|``)."""

    def __init__(self, *fragments: Fragment):
        self.fragments = fragments

    def matches(self, segment: str, module: Any) -> bool:
        return any(f.matches(segment, module) for f in self.fragments)

    def __repr__(self) -> str:
        return "|".join(repr(f) for f in self.fragments)
