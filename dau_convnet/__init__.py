"""dau_convnet: Displaced Aggregation Unit convolutions in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of skokec/DAU-ConvNet
(CVPR 2018 "Spatially-Adaptive Filter Units for Deep Neural Networks"):
learnable per-unit Gaussian displacement convolutions, a flax-free layer
core and AlexNet-DAU models, and (with the `nn` extra) a flax layer API
mirroring the reference TensorFlow plugin.
"""

__version__ = "0.1.0"

from .ops import (
    DAUConvSettings,
    blur_kernel_size,
    dau_conv2d_op,
    depthwise_blur,
    gaussian_filters,
)

__all__ = [
    "DAUConvSettings",
    "dau_conv2d_op",
    "blur_kernel_size",
    "depthwise_blur",
    "gaussian_filters",
    "__version__",
]
