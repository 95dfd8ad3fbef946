"""AlexNet-DAU: the reference's headline benchmark network.

The reference distributes three Caffe-trained AlexNet variants where the
conv2-conv5 layers are DAU layers (README.md:29-35):

- AlexNet-DAU-ConvNet-small: 0.3M DAU units (56.4% ImageNet top-1)
- AlexNet-DAU-ConvNet (default): 0.7M units (56.9%)
- AlexNet-DAU-ConvNet-large: 1.5M units (57.3%)

The unit budget is sum(S*G*F) over DAU layers; with AlexNet channel widths
(96-256-384-384-256) that is 0.37M / 0.74M / 1.48M units for G = 1 / 2 / 4
units per (s, f) pair - matching the three published budgets. conv1 stays a
standard strided convolution (stride-4 11x11 stem; DAU layers are stride-1
aggregation layers).

The models here need only JAX: each is a static description with
`init(rng, x) -> {"params": ...}` and `apply(variables, x)`, the contract
`parallel.make_train_step` consumes. The parameter tree keeps flax's
naming (conv/dense `kernel` + `bias`, DAU `weights`/`mu1`/`mu2`/`sigma`/
`bias`) so `parallel.param_shardings` applies unchanged. `AlexNetConv` is
the same network with plain 3x3 convolutions in place of the DAU layers,
the benchmark's baseline.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import jax
import jax.numpy as jnp

from ..nn.core import DAULayer

__all__ = ["AlexNetDAU", "AlexNetConv", "ALEXNET_DAU_VARIANTS"]

# variant name -> dau_units per layer (G = prod(units))
ALEXNET_DAU_VARIANTS = {
    "small": (1, 1),    # ~0.37M units
    "default": (2, 1),  # ~0.74M units
    "large": (2, 2),    # ~1.48M units
}

# (name, out channels, max-pool after) of the four middle layers
_MIDDLE = (("dau_conv2", 256, True), ("dau_conv3", 384, False),
           ("dau_conv4", 384, False), ("dau_conv5", 256, True))
_STEM_CHANNELS = 96
_FC_WIDTH = 4096

_lecun = jax.nn.initializers.lecun_normal()


def _max_pool_nchw(x, window=3, stride=2):
    y = jnp.transpose(x, (0, 2, 3, 1))
    y = jax.lax.reduce_window(y, -jnp.inf, jax.lax.max,
                              (1, window, window, 1), (1, stride, stride, 1),
                              "VALID")
    return jnp.transpose(y, (0, 3, 1, 2))


def _conv_nhwc(p, y, dtype, stride=1, padding="SAME"):
    out = jax.lax.conv_general_dilated(
        y.astype(dtype), p["kernel"].astype(dtype), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return out + p["bias"].astype(dtype)


def _dense(p, y, dtype):
    return y.astype(dtype) @ p["kernel"].astype(dtype) + p["bias"].astype(dtype)


def _init_dense(rng, shape):
    return {"kernel": _lecun(rng, shape, jnp.float32),
            "bias": jnp.zeros(shape[-1:], jnp.float32)}


def dau_input_hw(h: int, w: int):
    """Spatial size of each middle layer's input for an (h, w) image:
    stride-4 11x11 VALID stem, 3x3/2 VALID pools after conv1 and conv2."""
    def stem(n):
        return (n - 11) // 4 + 1

    def pool(n):
        return (n - 3) // 2 + 1

    first = (pool(stem(h)), pool(stem(w)))
    rest = (pool(first[0]), pool(first[1]))
    return {"dau_conv2": first, "dau_conv3": rest, "dau_conv4": rest,
            "dau_conv5": rest}


@dataclasses.dataclass(frozen=True)
class _AlexNetBase:
    num_classes: int = 1000
    dtype: tp.Any = jnp.float32

    def _init_middle(self, rng, in_ch, out_ch):
        raise NotImplementedError

    def _apply_middle(self, p, x, out_ch, phi):
        raise NotImplementedError

    def init(self, rng, x):
        """Fresh variables {"params": ...} for NCHW images shaped like x."""
        _, c, h, w = x.shape
        keys = jax.random.split(rng, 8)
        params = {"conv1": {
            "kernel": _lecun(keys[0], (11, 11, c, _STEM_CHANNELS), jnp.float32),
            "bias": jnp.zeros((_STEM_CHANNELS,), jnp.float32)}}
        in_ch = _STEM_CHANNELS
        for k, (name, out_ch, _) in zip(keys[1:5], _MIDDLE):
            params[name] = self._init_middle(k, in_ch, out_ch)
            in_ch = out_ch
        hw = dau_input_hw(h, w)["dau_conv5"]
        flat = in_ch * ((hw[0] - 3) // 2 + 1) * ((hw[1] - 3) // 2 + 1)
        params["fc6"] = _init_dense(keys[5], (flat, _FC_WIDTH))
        params["fc7"] = _init_dense(keys[6], (_FC_WIDTH, _FC_WIDTH))
        params["fc8"] = _init_dense(keys[7], (_FC_WIDTH, self.num_classes))
        return {"params": params}

    def apply(self, variables, x, phi_tables=None):
        """Logits for NCHW images x. `phi_tables` (from `phi_tables`)
        switches the DAU layers to the serving forward."""
        p = variables["params"]
        # conv1 stem: standard strided conv, NHWC
        y = jnp.transpose(x, (0, 2, 3, 1))
        y = jax.nn.relu(_conv_nhwc(p["conv1"], y, self.dtype, stride=4,
                                   padding="VALID"))
        x = _max_pool_nchw(jnp.transpose(y, (0, 3, 1, 2)))
        for name, out_ch, pool in _MIDDLE:
            phi = None if phi_tables is None else phi_tables[name]
            x = self._apply_middle(p[name], x, out_ch, phi)
            if pool:
                x = _max_pool_nchw(x)
        x = x.reshape(x.shape[0], -1)
        x = jax.nn.relu(_dense(p["fc6"], x, self.dtype))
        x = jax.nn.relu(_dense(p["fc7"], x, self.dtype))
        return _dense(p["fc8"], x, self.dtype)


@dataclasses.dataclass(frozen=True)
class AlexNetDAU(_AlexNetBase):
    """AlexNet with DAU conv2-conv5. Input NCHW (N, 3, 227, 227)."""

    variant: str = "default"
    max_kernel_size: int = 9
    # optional kernel-tier promise for all DAU layers (|mu| bound); pair with
    # utils.tiers.tier_for_params for the between-epochs re-jit workflow
    static_max_offset: tp.Optional[float] = None
    engine: str = "auto"

    def layer(self, out_ch: int) -> DAULayer:
        return DAULayer(filters=out_ch,
                        dau_units=ALEXNET_DAU_VARIANTS[self.variant],
                        max_kernel_size=self.max_kernel_size,
                        static_max_offset=self.static_max_offset,
                        engine=self.engine, dtype=self.dtype)

    def _init_middle(self, rng, in_ch, out_ch):
        return self.layer(out_ch).init(rng, in_ch)

    def _apply_middle(self, p, x, out_ch, phi):
        return self.layer(out_ch).apply(p, x, phi=phi, activation=jax.nn.relu)

    def phi_tables(self, variables, image_hw, dtype=None):
        """Serving: each DAU layer's phase table for frozen params and
        (H, W) images - pass to `apply(..., phi_tables=...)`. The flax-free
        form of `nn.DAUConv2d(phi_caching=True)`."""
        hw = dau_input_hw(*image_hw)
        p = variables["params"]
        return {name: self.layer(out_ch).build_phi(p[name], hw[name], dtype)
                for name, out_ch, _ in _MIDDLE}

    def num_dau_units(self, in_channels=(96, 256, 384, 384)) -> int:
        g = 1
        for u in ALEXNET_DAU_VARIANTS[self.variant]:
            g *= u
        return sum(s * g * f for s, (_, f, _) in zip(in_channels, _MIDDLE))


@dataclasses.dataclass(frozen=True)
class AlexNetConv(_AlexNetBase):
    """The conv3x3 baseline: AlexNetDAU's topology with plain 3x3
    convolutions (NHWC) in place of the DAU layers."""

    def _init_middle(self, rng, in_ch, out_ch):
        return {"kernel": _lecun(rng, (3, 3, in_ch, out_ch), jnp.float32),
                "bias": jnp.zeros((out_ch,), jnp.float32)}

    def _apply_middle(self, p, x, out_ch, phi):
        y = jnp.transpose(x, (0, 2, 3, 1))
        y = jax.nn.relu(_conv_nhwc(p, y, self.dtype))
        return jnp.transpose(y, (0, 3, 1, 2))
