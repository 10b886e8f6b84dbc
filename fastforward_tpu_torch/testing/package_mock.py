"""In-memory importable packages for tests
(`fastforward_tpu/testing/package_mock.py`).

A context manager that serves Python source strings through the import
system, so source-introspection tests need no real packages on disk: one
meta-path finder per active context materializes modules with an
in-memory loader, and the sources go into ``linecache`` so that
``inspect.getsource`` works on the fake modules.
"""

import importlib.abc
import importlib.machinery
import linecache
import sys
import textwrap
from types import ModuleType
from typing import Dict, Optional


def _origin(name: str) -> str:
    return f"<fastforward-tpu-torch-package-mock:{name}>"


class _MockLoader(importlib.abc.Loader):
    def __init__(self, sources: Dict[str, str]):
        self._sources = sources

    def create_module(self, spec) -> Optional[ModuleType]:
        return None  # default module creation

    def exec_module(self, module: ModuleType) -> None:
        name = module.__name__
        source = self._sources.get(name, "")
        filename = _origin(name)
        module.__file__ = filename  # lets inspect.getsource find linecache
        linecache.cache[filename] = (
            len(source),
            None,
            source.splitlines(keepends=True),
            filename,
        )
        code = compile(source, filename, "exec")
        exec(code, module.__dict__)


class _MockFinder(importlib.abc.MetaPathFinder):
    def __init__(self, sources: Dict[str, str], packages: set):
        self._sources = sources
        self._packages = packages
        self._loader = _MockLoader(sources)

    def find_spec(self, fullname, path=None, target=None):
        if fullname not in self._sources and fullname not in self._packages:
            return None
        is_pkg = fullname in self._packages
        spec = importlib.machinery.ModuleSpec(
            fullname, self._loader, origin=_origin(fullname), is_package=is_pkg
        )
        spec.has_location = False
        return spec


class PackageMock:
    """Context manager exposing source strings as importable modules.

    Example::

        pkg = PackageMock({"fake_pkg.mod": "def foo():\\n    return 1"})
        with pkg:
            from fake_pkg.mod import foo
            assert foo() == 1

    Parent packages are inferred from dotted names. On exit the finder is
    removed and the synthetic modules are purged from ``sys.modules`` and
    ``linecache``, so no state leaks between tests. Modules must be added
    before entering; the instance may be re-entered afterwards.
    """

    def __init__(self, sources: Optional[Dict[str, str]] = None):
        self._sources: Dict[str, str] = {}
        self._finder: Optional[_MockFinder] = None
        for name, src in (sources or {}).items():
            self.add_module(name, src)

    def add_module(self, qualified_name: str, source: str = "") -> "PackageMock":
        if self._finder is not None:
            raise RuntimeError("add modules before entering the context")
        parts = qualified_name.split(".")
        if not qualified_name or not all(p.isidentifier() for p in parts):
            raise ValueError(f"{qualified_name!r} is not a valid dotted module name")
        self._sources[qualified_name] = textwrap.dedent(source)
        return self

    def _package_names(self) -> set:
        pkgs = set()
        for name in self._sources:
            parts = name.split(".")
            for i in range(1, len(parts)):
                pkgs.add(".".join(parts[:i]))
        return pkgs

    def __enter__(self) -> "PackageMock":
        if self._finder is not None:
            raise RuntimeError("PackageMock context is not reentrant")
        self._finder = _MockFinder(dict(self._sources), self._package_names())
        sys.meta_path.insert(0, self._finder)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._finder is not None:
            try:
                sys.meta_path.remove(self._finder)
            except ValueError:
                pass
        for name in set(self._sources) | self._package_names():
            sys.modules.pop(name, None)
            linecache.cache.pop(_origin(name), None)
        self._finder = None
