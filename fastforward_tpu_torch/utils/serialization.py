"""YAML-serializable objects (`fastforward_tpu/utils/serialization.py`).

``@yamlable`` wraps ``__init__`` to record the constructor's arguments, so
that an instance round-trips as a ``{"type": qualified name, "args": ...}``
dict (`to_yamlable_dict` / `from_yamlable_dict`), and through YAML with the
``!ff.obj`` tag (`dump` / `load`). The port's granularities are decorated
at their definition. Only `dump` and `load` import PyYAML, inside their
bodies: importing the port loads no yaml.

Names resolve under ``fastforward_tpu_torch.`` only. A ``fastforward_tpu.``
name (written by the JAX package) is read as the port's module of the same
path, since the port keeps the JAX package's layout; any other name raises,
and no module of the JAX package is ever imported.
"""

import functools
import importlib
import inspect
from typing import Any

_YAML_TAG = "!ff.obj"
_REGISTRY: dict[str, type] = {}
_PORT = "fastforward_tpu_torch."
_JAX = "fastforward_tpu."


def yamlable(cls: type) -> type:
    """Class decorator: record init args, register for YAML round-tripping.

    Idempotent: re-decorating a class is a no-op for its ``__init__``.
    """
    if cls.__dict__.get("_ff_yamlable"):
        return cls
    cls._ff_yamlable = True
    original_init = cls.__init__
    sig = inspect.signature(original_init)

    @functools.wraps(original_init)
    def wrapped_init(self, *args: Any, **kwargs: Any) -> None:
        bound = sig.bind(self, *args, **kwargs)
        bound.apply_defaults()
        recorded = dict(bound.arguments)
        recorded.pop("self", None)
        recorded.pop("args", None)
        recorded.pop("kwargs", None)
        object.__setattr__(self, "_yaml_init_args", recorded)
        original_init(self, *args, **kwargs)

    cls.__init__ = wrapped_init
    _REGISTRY[f"{cls.__module__}.{cls.__qualname__}"] = cls
    return cls


def port_name(name: str) -> str:
    """``name`` as a name of the port: a ``fastforward_tpu.`` prefix maps
    onto ``fastforward_tpu_torch.``; a name outside both packages raises."""
    if name.startswith(_PORT):
        return name
    if name.startswith(_JAX):
        return _PORT + name[len(_JAX):]
    raise ValueError(f"{name!r} is not a name of fastforward_tpu_torch (or of the JAX "
                     "package's layout); refusing to import it")


def resolve_name(name: str) -> Any:
    """The object a qualified name of the port (or of the JAX package's
    layout, `port_name`) names."""
    name = port_name(name)
    if name in _REGISTRY:
        return _REGISTRY[name]
    mod_name, _, attr = name.rpartition(".")
    return getattr(importlib.import_module(mod_name), attr)


def _qualified_name(obj: Any) -> str:
    t = type(obj)
    return f"{t.__module__}.{t.__qualname__}"


def to_yamlable_dict(obj: Any) -> dict[str, Any]:
    if not hasattr(obj, "_yaml_init_args"):
        raise TypeError(f"{type(obj).__name__} is not @yamlable")
    args = {k: _encode(v) for k, v in obj._yaml_init_args.items()}
    return {"type": _qualified_name(obj), "args": args}


def _encode(value: Any) -> Any:
    if hasattr(value, "_yaml_init_args"):
        return to_yamlable_dict(value)
    if isinstance(value, (tuple, list)):
        # a new list each time: YAML would write a list object met twice as
        # an anchor and an alias
        return [_encode(v) for v in value]
    return value


def from_yamlable_dict(data: dict[str, Any]) -> Any:
    cls = resolve_name(data["type"])
    args = {k: _decode(v) for k, v in data.get("args", {}).items()}
    return cls(**args)


def _decode(value: Any) -> Any:
    if isinstance(value, dict) and "type" in value and "args" in value:
        return from_yamlable_dict(value)
    if isinstance(value, list):
        return tuple(_decode(v) for v in value)
    return value


@functools.lru_cache(maxsize=1)
def _yaml_classes():
    """PyYAML's dumper and loader with the ``!ff.obj`` tag (imported here,
    not at module import)."""
    import yaml

    class FFDumper(yaml.SafeDumper):
        pass

    class FFLoader(yaml.SafeLoader):
        pass

    def construct(loader, node):
        return from_yamlable_dict(loader.construct_mapping(node, deep=True))

    FFLoader.add_constructor(_YAML_TAG, construct)
    return yaml, FFDumper, FFLoader


def dump(data: Any) -> str:
    """YAML text of ``data``; @yamlable objects under the ``!ff.obj`` tag."""
    yaml, dumper, _ = _yaml_classes()

    def represent(d, obj):
        return d.represent_mapping(_YAML_TAG, to_yamlable_dict(obj))

    for cls in _REGISTRY.values():
        dumper.add_representer(cls, represent)
    return yaml.dump(data, Dumper=dumper, sort_keys=True)


def load(text: str) -> Any:
    """The data `dump` wrote (a JAX-written ``!ff.obj`` too: its type read
    as the port's)."""
    yaml, _, loader = _yaml_classes()
    return yaml.load(text, Loader=loader)
