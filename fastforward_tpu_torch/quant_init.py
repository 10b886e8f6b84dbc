"""Quantizer discovery and rule-based initialization
(`fastforward_tpu/quant_init.py`).

`find_quantizers(model, query)` finds quantizer slots by an mpath query
(a trailing ``[quantizer:tag]`` fragment filters by slot tags);
`QuantizerCollection.initialize` replaces them under an overwrite policy;
`QuantizationConfig` applies ordered (query, factory) rules, later rules
winning.
"""

from typing import Any, Callable, Optional, Union

from fastforward_tpu_torch import mpath
from fastforward_tpu_torch.exceptions import QuantizationError
from fastforward_tpu_torch.mpath.search import MPathCollection, MPathItem
from fastforward_tpu_torch.nn.quantizer import Quantizer, QuantizerStub

QuantizerFactory = Callable[..., Quantizer]


class QuantizerCollection(MPathCollection):
    """MPathCollection of quantizer slots with batch initialization."""

    def initialize(
        self,
        quantizer_factory: Union[type, QuantizerFactory],
        overwrite_policy: str = "overwrite",
        **kwargs: Any,
    ) -> None:
        """Replace every matched stub with ``quantizer_factory(**kwargs)``.

        ``overwrite_policy``:
          - "error": raise if the slot holds a non-stub quantizer;
          - "skip": leave non-stub quantizers untouched;
          - "overwrite": always replace.
        """
        for item in list(self):
            new = _initialize_quantizer(item, quantizer_factory, overwrite_policy, kwargs)
            if new is not None:
                item.update_module(new)


def _initialize_quantizer(
    item: MPathItem,
    factory: Union[type, QuantizerFactory],
    overwrite_policy: str,
    kwargs: dict[str, Any],
) -> Optional[Quantizer]:
    current = item.module
    if not isinstance(current, QuantizerStub):
        if overwrite_policy == "error":
            raise QuantizationError(
                f"Quantizer at '{item.full_name}' is already initialized "
                f"({type(current).__name__}) and overwrite_policy='error'."
            )
        if overwrite_policy == "skip":
            return None
    quantizer = factory(**kwargs)
    if not isinstance(quantizer, Quantizer):
        raise TypeError(
            f"Quantizer factory returned {type(quantizer).__name__}, expected a Quantizer"
        )
    # Preserve slot metadata from the stub (tags describing the slot kind).
    if getattr(current, "quant_metadata", None) is not None:
        quantizer.quant_metadata = current.quant_metadata
    return quantizer


def find_quantizers(
    model: Any, query: Any, context: Optional[dict[str, Any]] = None
) -> QuantizerCollection:
    """Find quantizer slots matching an mpath query.

    The query addresses the *quantizer modules themselves*; a trailing
    ``[quantizer:tag]`` fragment filters by slot tags, e.g.
    ``"**/[quantizer:parameter/weight]"``.
    """
    results = mpath.search(query, model, context=context)
    return QuantizerCollection([i for i in results if isinstance(i.module, Quantizer)])


class QuantizationConfig:
    """Declarative quantizer placement: ordered (query, factory) rules.

    Later rules take precedence. `initialize(model)` applies the
    highest-precedence rule to every quantizer slot it matches.
    """

    def __init__(self) -> None:
        self._rules: list[tuple[Any, Union[type, QuantizerFactory], dict[str, Any]]] = []

    def add_rule(
        self,
        query: Any,
        quantizer_factory: Union[type, QuantizerFactory],
        **kwargs: Any,
    ) -> "QuantizationConfig":
        self._rules.append((query, quantizer_factory, kwargs))
        return self

    def initialize(
        self,
        model: Any,
        overwrite_policy: str = "overwrite",
        context: Optional[dict[str, Any]] = None,
    ) -> None:
        # Apply rules in order; later rules overwrite earlier matches, which
        # realizes last-wins precedence without explicit scoring.
        for query, factory, kwargs in self._rules:
            collection = find_quantizers(model, query, context=context)
            collection.initialize(factory, overwrite_policy=overwrite_policy, **kwargs)
