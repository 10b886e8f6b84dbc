"""Quantizer modules: base class, stub, tags and metadata
(`fastforward_tpu/nn/quantizer.py`).

`Tag` interned hierarchical symbols, `QuantizerMetadata`, the `Quantizer`
base with override support and the `QuantizerStub` placeholder. Quantizers
are `torch.nn.Module`s, so their parameters (scale, offset) are ordinary
`nn.Parameter`s that move with ``.to()``, save in ``state_dict()`` and
train with any optimizer.
"""

from typing import Any, Iterator, Optional

import torch

from fastforward_tpu_torch.forward_override import OverrideMixin, apply_overrides


class Tag:
    """Interned hierarchical tag, e.g. ``Tag("parameter/weight")``.

    A tag matches itself and all its ancestors:
    ``Tag("parameter/weight").is_subtag_of(Tag("parameter"))`` is True.
    """

    _interned: dict[str, "Tag"] = {}

    def __new__(cls, name: str) -> "Tag":
        if name in cls._interned:
            return cls._interned[name]
        obj = super().__new__(cls)
        obj._name = name  # type: ignore[attr-defined]
        cls._interned[name] = obj
        return obj

    @property
    def name(self) -> str:
        return self._name  # type: ignore[attr-defined]

    def is_subtag_of(self, other: "Tag") -> bool:
        if self is other:
            return True
        return self.name.startswith(other.name + "/")

    def parents(self) -> Iterator["Tag"]:
        parts = self.name.split("/")
        for i in range(len(parts) - 1, 0, -1):
            yield Tag("/".join(parts[:i]))

    def __repr__(self) -> str:
        return f"Tag({self.name!r})"

    def __hash__(self) -> int:
        return hash(self.name)


class QuantizerMetadata:
    """Describes a quantizer slot: tags, input shape, weight/activation kind."""

    def __init__(
        self,
        *tags: Tag | str,
        input_shape: Optional[tuple[int, ...]] = None,
        weight_quantizer: bool = False,
        bias_quantizer: bool = False,
        output_quantizer: bool = False,
        input_quantizer: bool = False,
    ):
        base_tags = [Tag(t) if isinstance(t, str) else t for t in tags]
        if weight_quantizer:
            base_tags.append(Tag("parameter/weight"))
        if bias_quantizer:
            base_tags.append(Tag("parameter/bias"))
        if output_quantizer:
            base_tags.append(Tag("activation/output"))
        if input_quantizer:
            base_tags.append(Tag("activation/input"))
        self.tags: tuple[Tag, ...] = tuple(dict.fromkeys(base_tags))
        self.input_shape = input_shape

    def matches_tag(self, tag: Tag | str) -> bool:
        tag = Tag(tag) if isinstance(tag, str) else tag
        return any(t.is_subtag_of(tag) for t in self.tags)

    def with_extras(self, **kwargs: Any) -> "QuantizerMetadata":
        new = QuantizerMetadata(*self.tags, input_shape=self.input_shape)
        for k, v in kwargs.items():
            setattr(new, k, v)
        return new

    def __repr__(self) -> str:
        return f"QuantizerMetadata(tags={[t.name for t in self.tags]})"


class Quantizer(torch.nn.Module, OverrideMixin):
    """Base class for all quantizer modules.

    Subclasses implement `quantize(data)`. Calling the quantizer applies the
    override stack around `quantize`.
    """

    is_stub = False

    def __init__(self):
        super().__init__()
        self.quant_metadata: Optional[QuantizerMetadata] = None

    def quantize(self, data: torch.Tensor):
        raise NotImplementedError

    def forward(self, data, *args: Any, **kwargs: Any):
        if self.has_overrides:
            return apply_overrides(self, self.quantize)(data, *args, **kwargs)
        return self.quantize(data, *args, **kwargs)


class QuantizerStub(Quantizer):
    """Placeholder quantizer: passes data through unchanged.

    Conversion installs stubs into every quantizer slot; configuration
    replaces them with real quantizers.
    """

    is_stub = True

    def __init__(self, *tags: Tag | str, _metadata: Optional[QuantizerMetadata] = None,
                 **kwargs: Any):
        super().__init__()
        self.quant_metadata = _metadata or QuantizerMetadata(*tags, **kwargs)

    def quantize(self, data, *args: Any, **kwargs: Any):
        return data
