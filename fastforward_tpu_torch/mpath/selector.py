"""Selector algebra (`fastforward_tpu/mpath/selector.py`).

`BaseSelector` with ``/`` (path join) and ``&`` / ``|`` (intersection and
union over result sets); `Selector` (a fragment chain, sliceable) and
`MultiSelector` (a union of selectors).
"""

from typing import Any, Sequence

from fastforward_tpu_torch.mpath.fragments import Fragment


class BaseSelector:
    def __truediv__(self, other: Any) -> "BaseSelector":
        other = _to_selector(other)
        return self.join(other)

    def __rtruediv__(self, other: Any) -> "BaseSelector":
        return _to_selector(other).join(self)

    def __or__(self, other: Any) -> "BaseSelector":
        other = _to_selector(other)
        selectors: list[BaseSelector] = []
        for s in (self, other):
            if isinstance(s, MultiSelector):
                selectors.extend(s.selectors)
            else:
                selectors.append(s)
        return MultiSelector(selectors)

    def __and__(self, other: Any) -> "BaseSelector":
        return IntersectionSelector(self, _to_selector(other))

    def join(self, other: "BaseSelector") -> "BaseSelector":
        raise NotImplementedError

    def fragment_chains(self) -> list[tuple[Fragment, ...]]:
        """All flat fragment chains this selector represents."""
        raise NotImplementedError


class Selector(BaseSelector):
    """A chain of fragments matched against path segments in order."""

    def __init__(self, fragments: Sequence[Fragment]):
        self.fragments = tuple(fragments)

    def join(self, other: BaseSelector) -> BaseSelector:
        if isinstance(other, Selector):
            return Selector(self.fragments + other.fragments)
        if isinstance(other, MultiSelector):
            return MultiSelector([self.join(s) for s in other.selectors])
        raise TypeError(f"Cannot join Selector with {type(other)}")

    def fragment_chains(self) -> list[tuple[Fragment, ...]]:
        return [self.fragments]

    def __getitem__(self, item):
        fragments = self.fragments[item]
        if isinstance(fragments, Fragment):
            fragments = (fragments,)
        return Selector(fragments)

    def __repr__(self) -> str:
        return "/".join(repr(f) for f in self.fragments)


class MultiSelector(BaseSelector):
    """Union of selectors: matches if any member matches."""

    def __init__(self, selectors: Sequence[BaseSelector]):
        self.selectors = tuple(selectors)

    def join(self, other: BaseSelector) -> BaseSelector:
        return MultiSelector([s.join(other) for s in self.selectors])

    def fragment_chains(self) -> list[tuple[Fragment, ...]]:
        chains: list[tuple[Fragment, ...]] = []
        for s in self.selectors:
            chains.extend(s.fragment_chains())
        return chains

    def __repr__(self) -> str:
        return " | ".join(repr(s) for s in self.selectors)


class IntersectionSelector(BaseSelector):
    """Matches paths matched by *all* member selectors."""

    def __init__(self, *selectors: BaseSelector):
        self.selectors = selectors

    def join(self, other: BaseSelector) -> BaseSelector:
        raise TypeError("Cannot extend an intersection selector with /")

    def fragment_chains(self) -> list[tuple[Fragment, ...]]:
        raise TypeError("Intersection selectors have no flat fragment chains")

    def __repr__(self) -> str:
        return " & ".join(repr(s) for s in self.selectors)


def _to_selector(value: Any) -> BaseSelector:
    from fastforward_tpu_torch.mpath.parser import parse

    if isinstance(value, BaseSelector):
        return value
    if isinstance(value, Fragment):
        return Selector([value])
    if isinstance(value, str):
        return parse(value)
    raise TypeError(f"Cannot convert {type(value)} to a selector")
