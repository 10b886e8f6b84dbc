"""The port's context flags, dispatcher and forward overrides
(`fastforward_tpu_torch/flags.py`, `dispatcher.py`, `forward_override.py`)
against the JAX package's, on the CPU: the same defaults and scoping of
the three context flags and the ``context`` decorator; the same kernel
chosen for the same registrations and calls (priority bands, the newest
registration first within a band, predicates composed with ``& | ~``,
registration by call, decorator and context manager, removal); the same
order of stacked overrides, here around an ``nn.Module.forward``.
"""

import pytest
import torch

from fastforward_tpu import dispatcher as jd
from fastforward_tpu import flags as jflags
from fastforward_tpu import forward_override as jfo
from fastforward_tpu_torch import dispatcher as td
from fastforward_tpu_torch import exceptions as texc
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch import forward_override as tfo

FLAGS = (("strict_quantization", True), ("export_mode", False), ("use_kernels", True))


@pytest.fixture(autouse=True)
def _clean_registries():
    saved = [(m, dict(m._DISPATCHER)) for m in (jd, td)]
    for m, _ in saved:
        m._DISPATCHER.clear()
    yield
    for m, reg in saved:
        m._DISPATCHER.clear()
        m._DISPATCHER.update(reg)


@pytest.mark.parametrize("name,default", FLAGS)
def test_context_flags_match_jax(name, default):
    trail = {}
    for mod in (jflags, tflags):
        get, set_, manager = (getattr(mod, f"get_{name}"), getattr(mod, f"set_{name}"),
                              getattr(mod, name))
        seen = [get()]
        with manager(not default):
            seen.append(get())
            with manager(default):
                seen.append(get())
            seen.append(get())
        seen.append(get())
        set_(not default)
        seen.append(get())
        set_(default)

        @mod.context(manager, not default)
        def inside():
            return get()

        seen += [inside(), get(), manager.__name__, get.__name__, set_.__name__]
        trail[mod.__name__] = seen
    assert trail["fastforward_tpu.flags"] == trail["fastforward_tpu_torch.flags"]
    assert trail["fastforward_tpu_torch.flags"][0] is default


def test_exceptions_are_distinct_types():
    for name in ("QuantizationError", "ExportError", "AutoquantError"):
        cls = getattr(texc, name)
        assert issubclass(cls, Exception) and cls.__name__ == name
    assert not issubclass(texc.QuantizationError, texc.ExportError)


def _script(mod):
    """The same registrations on either dispatcher; the kernels name
    themselves."""
    P, prio = mod.Predicate, mod.DispatcherPriority
    pos = P(lambda x: x > 0, name="pos")
    even = P(lambda x: x % 2 == 0, name="even")
    mod.register("op", lambda x: "fallback", priority=prio.FALLBACK)
    mod.register("op", lambda x: "not-impl", priority=prio.NOT_IMPLEMENTED_FALLBACK)
    mod.register("op", lambda x: "pos", predicate=pos)
    first_even = mod.register("op", lambda x: "pos-even", predicate=pos & even)
    mod.register("op", lambda x: "neg-or-even", predicate=~pos | even)
    mod.register("op", lambda x, y: "two-args", predicate=P(lambda x, y: True))
    mod.register("op", lambda x: "odd-fallback", predicate=~even, priority=prio.FALLBACK)

    @mod.register("other", predicate=mod.predicate(lambda x: x == 3))
    def three(x):
        return "three"

    return first_even, repr(pos & even), repr(~pos | even)


def test_dispatcher_chooses_as_jax():
    got = {}
    for mod in (jd, td):
        handle, r1, r2 = _script(mod)
        picks = [mod.dispatch("op", x)(x) for x in range(-3, 5)]
        picks.append(mod.dispatch("op", 1, 2)(1, 2))
        picks += [mod.dispatch("other", 3)(3), mod.dispatch("other", 4), mod.dispatch("none", 1)]
        handle.remove()
        picks += [mod.dispatch("op", x)(x) for x in (2, 4)]
        with mod.dispatcher_context("op", lambda x: "temp"):
            picks.append(mod.dispatch("op", 5)(5))
        picks.append(mod.dispatch("op", 5)(5))
        with mod.register("op", lambda x: "scoped", predicate=mod.Predicate(lambda x: x == 7)):
            picks.append(mod.dispatch("op", 7)(7))
        picks.append(mod.dispatch("op", 7)(7))
        picks += [r1, r2, [i.priority for i in mod.registered_kernels("op")]]
        got[mod.__name__] = picks
    assert got["fastforward_tpu.dispatcher"] == got["fastforward_tpu_torch.dispatcher"]


class _Linear(torch.nn.Module, tfo.OverrideMixin):
    """A module whose forward runs its override stack."""

    def __init__(self):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.full((3,), 2.0))

    def _forward(self, x, shift=0.0):
        return x * self.weight + shift

    def forward(self, x, shift=0.0):
        return tfo.apply_overrides(self, self._forward)(x, shift=shift)


class _JaxCallable(jfo.OverrideMixin):
    def __call__(self, x, shift=0.0):
        return jfo.apply_overrides(self, lambda x, shift=0.0: x * 2.0 + shift)(x, shift=shift)


def test_forward_overrides_stack_as_jax():
    trail = {}
    for name, obj, mod in (("jax", _JaxCallable(), jfo), ("torch", _Linear(), tfo)):
        log = []

        def tag(label):
            def override(ctx, inner, args, kwargs):
                log.append(f"{label}>")
                out = inner(*args, **kwargs)
                log.append(f"<{label}")
                return out + 1.0
            return override

        x = torch.ones(3) if name == "torch" else 1.0

        def value(y):
            return float(y.detach().mean()) if isinstance(y, torch.Tensor) else float(y)

        h1 = obj.register_override(tag("a"))
        h2 = obj.register_override(tag("b"))
        outs = [value(obj(x, shift=0.5))]
        with h2:
            assert obj.has_overrides
        outs.append(value(obj(x)))
        h1.remove()
        outs += [value(obj(x)), obj.has_overrides]
        trail[name] = (log, isinstance(h1, mod.OverrideHandle), h1.enabled)
        trail[name + "_outs"] = outs
    assert trail["jax"] == trail["torch"]
    assert trail["jax_outs"] == trail["torch_outs"] == [4.5, 3.0, 2.0, False]
