"""Keep a former top-level package name importing as this package."""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys

_PACKAGE = __name__.split(".")[0]


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<old>.<sub>`` to the module object ``<package>.<sub>``."""

    def __init__(self, old: str):
        self.old = old
        self._real_specs = {}

    def _target(self, name: str) -> str:
        return _PACKAGE + name[len(self.old):]

    def find_spec(self, name, path=None, target=None):
        if not name.startswith(self.old + "."):
            return None
        real = importlib.util.find_spec(self._target(name))
        if real is None:
            return None
        return importlib.util.spec_from_loader(
            name, self, origin=real.origin,
            is_package=real.submodule_search_locations is not None)

    def create_module(self, spec):
        module = importlib.import_module(self._target(spec.name))
        self._real_specs[spec.name] = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias spec on the shared module
        module.__spec__ = self._real_specs.pop(module.__spec__.name)

    def get_code(self, name):
        """For ``python -m <old>.<module>``."""
        real = importlib.util.find_spec(self._target(name))
        return real.loader.get_code(real.name)


def alias_package(old: str) -> None:
    """Make ``old`` and every ``old.<sub>`` import as this package's modules
    (the same objects, so classes and state are shared)."""
    sys.modules[old] = importlib.import_module(_PACKAGE)
    if not any(isinstance(f, _AliasFinder) and f.old == old
               for f in sys.meta_path):
        sys.meta_path.insert(0, _AliasFinder(old))
