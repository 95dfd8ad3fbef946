"""Model zoo. AlexNet-DAU needs only JAX; the CIFAR and ResNet models are
flax modules (the `nn` extra) and are imported on first use."""

from .alexnet import ALEXNET_DAU_VARIANTS, AlexNetConv, AlexNetDAU

_FLAX_MODELS = {"ConvCifarNet": "cifar", "DAUCifarNet": "cifar",
                "DAUResNet": "resnet", "RESNET_DAU_DEPTHS": "resnet"}

__all__ = ["AlexNetDAU", "AlexNetConv", "ALEXNET_DAU_VARIANTS",
           *_FLAX_MODELS]


def __getattr__(name):
    if name in _FLAX_MODELS:
        import importlib
        module = importlib.import_module(f".{_FLAX_MODELS[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
