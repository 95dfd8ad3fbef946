"""Former name of the `dau_convnet` package, kept so that old imports work.

Importing this package, or any module under it, gives the `dau_convnet`
module of the same path itself (the same object, so classes and settings
compare equal across the two names), with a DeprecationWarning.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import dau_convnet

_NEW = "dau_convnet"


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves `<old name>.x.y` to the already importable `dau_convnet.x.y`."""

    def __init__(self, old):
        self.old = old

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(self.old + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        return importlib.import_module(_NEW + spec.name[len(self.old):])

    def exec_module(self, module):
        pass


warnings.warn(f"the package {__name__} is now {_NEW}; import {_NEW}",
              DeprecationWarning, stacklevel=2)
sys.meta_path.insert(0, _AliasFinder(__name__))
sys.modules[__name__] = dau_convnet
