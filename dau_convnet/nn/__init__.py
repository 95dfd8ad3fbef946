"""DAU layers: the flax-free core (`DAULayer` and its helpers) and, with the
`nn` extra installed, the flax modules wrapping it. The flax names are
imported on first use, so `import dau_convnet.nn` needs only JAX."""

from .core import (
    DAU_UNITS_GROUP,
    DAUGridMean,
    DAULayer,
    ZeroNLast,
    project_dau_params,
    set_dau_variables_manually,
)

_FLAX_NAMES = ("DAUConv1d", "DAUConv2d", "dau_conv1d", "dau_conv2d",
               "refresh_phi_cache")

__all__ = [
    "DAU_UNITS_GROUP",
    "DAUGridMean",
    "DAULayer",
    "ZeroNLast",
    "project_dau_params",
    "set_dau_variables_manually",
    *_FLAX_NAMES,
]


def __getattr__(name):
    if name in _FLAX_NAMES:
        from . import layers
        return getattr(layers, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
