"""mpath search engine (`fastforward_tpu/mpath/search.py`).

Walks a `torch.nn.Module` tree, matches selector fragment chains against
module paths (regex-style matching with ``**`` multi-wildcards), and
returns an `MPathCollection` supporting set operations and batch module
replacement.

A path is the tuple of segments of a name from ``named_modules()``, torch's
``.``-joined name split at each ``.``: ``layers.0.self_attn`` is
``("layers", "0", "self_attn")``, and ``full_name`` joins it with ``/`` as
the JAX package does (``layers/0/self_attn``). A container's children keep
their string indices; a `ModuleList` or `ModuleDict` itself is not in the
index, as the NNX model's plain list or dict is no module. Results are
sorted by that tuple of strings, so ``"10"`` comes before ``"2"``, as in
the JAX package.
"""

from typing import Any, Callable, Iterator, Optional, Sequence

import torch

from fastforward_tpu_torch.mpath.fragments import Fragment
from fastforward_tpu_torch.mpath.selector import BaseSelector, IntersectionSelector

_INDEXED = (list, torch.nn.ModuleList, torch.nn.Sequential)
_KEYED = (dict, torch.nn.ModuleDict)


class MPathItem:
    """One search result: the module, its path, and enough context to
    replace it in the tree."""

    def __init__(self, root: Any, path: tuple[str, ...], module: Any):
        self.root = root
        self.path = path
        self.module = module

    @property
    def full_name(self) -> str:
        return "/".join(self.path)

    def update_module(self, new_module: Any) -> None:
        """Replace this module in the tree: index assignment in a
        `ModuleList` or `Sequential`, key assignment in a `ModuleDict`,
        else ``setattr`` on the parent module."""
        parent = self.root
        for seg in self.path[:-1]:
            parent = _step(parent, seg)
        last = self.path[-1]
        if isinstance(parent, _INDEXED):
            parent[int(last)] = new_module
        elif isinstance(parent, _KEYED):
            parent[last] = new_module
        else:
            setattr(parent, last, new_module)
        self.module = new_module

    def __repr__(self) -> str:
        return f"MPathItem({self.full_name}: {type(self.module).__name__})"


def _step(obj: Any, segment: str) -> Any:
    if isinstance(obj, _INDEXED + (tuple,)):
        return obj[int(segment)]
    if isinstance(obj, _KEYED):
        return obj[segment]
    return getattr(obj, segment)


class MPathCollection(Sequence):
    """An ordered set of MPathItems with set operations and a batch
    `update_modules`."""

    def __init__(self, items: Sequence[MPathItem] = ()):
        self._items = list(items)

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return MPathCollection(self._items[i])
        return self._items[i]

    def __iter__(self) -> Iterator[MPathItem]:
        return iter(self._items)

    @property
    def paths(self) -> list[str]:
        return [item.full_name for item in self._items]

    @property
    def modules(self) -> list[Any]:
        return [item.module for item in self._items]

    def __or__(self, other: "MPathCollection") -> "MPathCollection":
        seen = {i.path for i in self._items}
        extra = [i for i in other if i.path not in seen]
        return MPathCollection(self._items + extra)

    def __and__(self, other: "MPathCollection") -> "MPathCollection":
        keep = {i.path for i in other}
        return MPathCollection([i for i in self._items if i.path in keep])

    def __sub__(self, other: "MPathCollection") -> "MPathCollection":
        drop = {i.path for i in other}
        return MPathCollection([i for i in self._items if i.path not in drop])

    def update_modules(self, factory: Callable[[MPathItem], Any]) -> None:
        """Replace every matched module with ``factory(item)``."""
        for item in self._items:
            item.update_module(factory(item))

    def __repr__(self) -> str:
        lines = ",\n  ".join(repr(i) for i in self._items)
        return f"MPathCollection([\n  {lines}\n])" if self._items else "MPathCollection([])"


def _module_index(root: torch.nn.Module) -> dict[tuple[str, ...], Any]:
    """Every module of the tree by its path. A `ModuleList` or `ModuleDict`
    stands for the plain list or dict that holds modules in an NNX model,
    which is no module there: its children are indexed under its name, and
    it is not."""
    index: dict[tuple[str, ...], Any] = {(): root}
    for name, module in root.named_modules():
        if name and not isinstance(module, (torch.nn.ModuleList, torch.nn.ModuleDict)):
            index[tuple(name.split("."))] = module
    return index


def _chain_matches(
    chain: tuple[Fragment, ...],
    path: tuple[str, ...],
    index: dict[tuple[str, ...], Any],
) -> bool:
    n_frag, n_seg = len(chain), len(path)

    from functools import lru_cache

    @lru_cache(maxsize=None)
    def match(fi: int, si: int) -> bool:
        if fi == n_frag:
            return si == n_seg
        frag = chain[fi]
        if frag.is_multi:
            # ``**``: skip the fragment, or consume one segment and retry.
            if match(fi + 1, si):
                return True
            return si < n_seg and match(fi, si + 1)
        if si >= n_seg:
            return False
        module = index.get(path[: si + 1])
        return frag.matches(path[si], module) and match(fi + 1, si + 1)

    return match(0, 0)


def _selector_matches(
    selector: BaseSelector,
    path: tuple[str, ...],
    index: dict[tuple[str, ...], Any],
) -> bool:
    if isinstance(selector, IntersectionSelector):
        return all(_selector_matches(s, path, index) for s in selector.selectors)
    return any(_chain_matches(chain, path, index) for chain in selector.fragment_chains())


def search(selector, root, context: Optional[dict[str, Any]] = None) -> MPathCollection:
    """Find all modules in ``root`` whose path matches ``selector``.

    ``selector`` may be a query string or a Selector.
    """
    from fastforward_tpu_torch.mpath import query as parse_query

    selector = parse_query(selector, context=context)
    index = _module_index(root)
    items = [
        MPathItem(root, path, module)
        for path, module in index.items()
        if path and _selector_matches(selector, path, index)
    ]
    # Deterministic order: by path.
    items.sort(key=lambda i: i.path)
    return MPathCollection(items)
