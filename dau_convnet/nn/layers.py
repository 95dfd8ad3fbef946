"""Flax layer API mirroring the reference TensorFlow plugin's Python surface.

Reference: plugins/tensorflow/dau_conv/dau_conv.py -
`DAUConv2d` (:221-555), `DAUConv1d` (:557-570), and the contrib-style
`dau_conv2d` / `dau_conv1d` wrappers (:579-795). Parameter names, shapes
([1, S, G, F]), defaults and behavioral quirks (unit rounding to groups of
2, stride emulation by output slicing, layer-level mu clipping, single
shared non-trainable sigma) are kept; TF Session-era plumbing
(collections, variable_scope, regularizer hooks) maps to idiomatic
flax/optax (regularizers are applied by the loss, constraints by the
optimizer).

These modules are thin wrappers over the flax-free core
(`dau_convnet.nn.core.DAULayer`), which holds the layer's semantics; this
module needs the `nn` extra (flax). Extensions over the reference: NHWC is
supported in addition to NCHW (the reference is NCHW-only,
dau_conv.py:163-181), and any number of output channels is allowed (no
multiple-of-16/32 restriction - that was a CUDA warp-layout constraint,
README.md:225).
"""

from __future__ import annotations

import typing as tp

import jax
import jax.numpy as jnp
from flax import linen as nn

from .core import DAULayer

__all__ = ["DAUConv2d", "DAUConv1d", "dau_conv2d", "dau_conv1d",
           "refresh_phi_cache"]


def refresh_phi_cache(model, variables, sample_input):
    """Recompute every `phi_caching` layer's cached phase table from the
    CURRENT params (serving: call once after loading/updating weights).

    Runs one forward with the 'phi_cache' collection mutable and returns
    the variables pytree with the refreshed cache installed. `sample_input`
    must have the serving spatial shape and dtype (the table is built for
    them).
    """
    variables = dict(variables)
    _, upd = model.apply(variables, sample_input, mutable=["phi_cache"])
    variables["phi_cache"] = upd["phi_cache"]
    return variables


class DAUConv2d(nn.Module):
    """Displaced Aggregation Unit 2D convolution layer.

    Drop-in analogue of the reference `DAUConv2d` (dau_conv.py:221-555);
    constructor argument names and defaults match the reference README
    (README.md:150-190). Input is NCHW for data_format='channels_first'
    (reference behavior) or NHWC for 'channels_last' (extension).

    Parameters (flax): weights/mu1/mu2 of shape [1, S, G, F], sigma of
    shape [1] (single shared Gaussian width, tiled internally; trainable
    only when `dau_sigma_trainable` - reference dau_conv.py:417-430), and
    bias [F].

    To load custom/pretrained DAU parameters (the reference's
    `set_dau_variables_manually`, dau_conv.py:344-359), use
    `dau_convnet.nn.set_dau_variables_manually(variables, layer_name, ...)`
    on the initialized params pytree.
    """

    filters: int
    dau_units: tp.Tuple[int, int]
    max_kernel_size: int
    strides: int = 1
    data_format: str = "channels_first"
    activation: tp.Optional[tp.Callable] = None
    use_bias: bool = True
    # None = the layer's default (DAULayer.initializers)
    weight_initializer: tp.Optional[tp.Callable] = None
    mu1_initializer: tp.Optional[tp.Callable] = None
    mu2_initializer: tp.Optional[tp.Callable] = None
    sigma_initializer: tp.Optional[tp.Callable] = None
    bias_initializer: tp.Optional[tp.Callable] = None
    # constraints are applied to the parameter value before use (reference
    # applies tf constraints on assignment; functionally equivalent here).
    weight_constraint: tp.Optional[tp.Callable] = None
    mu1_constraint: tp.Optional[tp.Callable] = None
    mu2_constraint: tp.Optional[tp.Callable] = None
    sigma_constraint: tp.Optional[tp.Callable] = None
    bias_constraint: tp.Optional[tp.Callable] = None
    # regularizers: collected via `regularization_loss(params)` (TF variable
    # collections have no flax analogue; add the returned scalar to the loss)
    weight_regularizer: tp.Optional[tp.Callable] = None
    mu1_regularizer: tp.Optional[tp.Callable] = None
    mu2_regularizer: tp.Optional[tp.Callable] = None
    sigma_regularizer: tp.Optional[tp.Callable] = None
    bias_regularizer: tp.Optional[tp.Callable] = None
    # the remaining fields are DAULayer's (see its field docs)
    mu_learning_rate_factor: float = 500.0
    dau_unit_border_bound: float = 0.01
    dau_unit_single_dim: bool = False
    dau_aggregation_forbid_positive_dim1: bool = False
    dau_sigma_trainable: bool = False
    dau_mu_interpolation: bool = True
    dau_sigma_init: float = 0.5
    dau_sigma_max: tp.Optional[float] = None
    unit_testing: bool = False
    static_max_offset: tp.Optional[float] = None
    engine: str = "auto"
    remat_phi: bool = False
    # SERVING: cache the fourier phase table as a 'phi_cache' flax variable
    # collection. At init the cache is computed from the fresh params; at
    # apply the layer consumes the cached table and skips the per-call
    # build (a constant at serving - the reference has no serving path;
    # this extends its "prefilter cached until sigma changes" idea,
    # base_dau_conv_layer.cpp:414-434, to the offset table). INFERENCE
    # ONLY: the cached-phi forward carries no w/mu gradients. After
    # loading trained params, refresh with `refresh_phi_cache` (or
    # apply(..., mutable=['phi_cache'])). No-op for non-fourier engines.
    phi_caching: bool = False
    precision: tp.Optional[str] = None
    dtype: tp.Any = jnp.float32

    @property
    def padding(self) -> int:
        return self.max_kernel_size // 2

    def core(self) -> DAULayer:
        """The flax-free layer these fields describe."""
        return DAULayer(
            filters=self.filters, dau_units=tuple(self.dau_units),
            max_kernel_size=self.max_kernel_size, strides=self.strides,
            data_format=self.data_format, use_bias=self.use_bias,
            mu_learning_rate_factor=self.mu_learning_rate_factor,
            dau_unit_border_bound=self.dau_unit_border_bound,
            dau_unit_single_dim=self.dau_unit_single_dim,
            dau_aggregation_forbid_positive_dim1=(
                self.dau_aggregation_forbid_positive_dim1),
            dau_sigma_trainable=self.dau_sigma_trainable,
            dau_mu_interpolation=self.dau_mu_interpolation,
            dau_sigma_init=self.dau_sigma_init,
            dau_sigma_max=self.dau_sigma_max,
            unit_testing=self.unit_testing,
            static_max_offset=self.static_max_offset,
            engine=self.engine, remat_phi=self.remat_phi,
            precision=self.precision, dtype=self.dtype)

    @property
    def num_dau_units_all(self) -> int:
        return self.core().unit_info[1]

    @property
    def num_dau_units_ignore(self) -> int:
        return self.core().unit_info[2]

    def dau_param_shape(self, in_channels: int):
        return self.core().param_shape(in_channels)

    def regularization_loss(self, params) -> jax.Array:
        """Sum of the configured per-parameter regularizers over this layer's
        param dict (reference: TF regularization-loss collections,
        dau_conv.py:387-440). Add the result to your training loss."""
        pairs = (("weights", self.weight_regularizer),
                 ("mu1", self.mu1_regularizer),
                 ("mu2", self.mu2_regularizer),
                 ("sigma", self.sigma_regularizer),
                 ("bias", self.bias_regularizer))
        total = jnp.zeros(())
        for name, reg in pairs:
            if reg is not None and name in params:
                total = total + reg(params[name])
        return total

    @nn.compact
    def __call__(self, inputs):
        core = self.core()
        if inputs.ndim != 4:
            raise ValueError(f"DAUConv2d expects rank-4 input, got {inputs.shape}")
        s_ch = inputs.shape[-1] if core.channels_last else inputs.shape[1]
        pshape = core.param_shape(s_ch)
        inits = core.initializers(
            weights=self.weight_initializer, mu1=self.mu1_initializer,
            mu2=self.mu2_initializer, sigma=self.sigma_initializer,
            bias=self.bias_initializer)
        constraints = {"weights": self.weight_constraint,
                       "mu1": self.mu1_constraint,
                       "mu2": self.mu2_constraint,
                       "sigma": self.sigma_constraint,
                       "bias": self.bias_constraint}
        shapes = {"weights": pshape, "mu1": pshape, "mu2": pshape,
                  "sigma": (1,)}
        if self.use_bias:
            shapes["bias"] = (self.filters,)
        params = {}
        for name, shape in shapes.items():
            value = self.param(name, inits[name], shape, self.dtype)
            if constraints[name] is not None:
                value = constraints[name](value)
            params[name] = value

        phi = None
        if self.phi_caching and core.settings().engine == "fourier":
            h, w = (inputs.shape[1:3] if core.channels_last
                    else inputs.shape[2:])

            def build():
                return core.build_phi(params, (h, w), inputs.dtype)

            pv = self.variable("phi_cache", "phi", build)
            if (not self.is_initializing()
                    and self.is_mutable_collection("phi_cache")):
                pv.value = build()  # explicit mutable apply = refresh
            phi = pv.value
        return core.apply(params, inputs, phi=phi, activation=self.activation)


class DAUConv1d(DAUConv2d):
    """1D DAU convolution: units displace only along x; the aggregation
    kernel is masked to the centre row (reference dau_conv.py:557-570).
    """

    dau_unit_single_dim: bool = True


def dau_conv2d(inputs, filters, dau_units, max_kernel_size, *,
               stride=1, mu_learning_rate_factor=500,
               data_format="channels_first",
               activation_fn=nn.relu, normalizer_fn=None,
               normalizer_params=None,
               weights_initializer=None,
               weights_regularizer=None, weights_constraint=None,
               mu1_initializer=None, mu1_regularizer=None, mu1_constraint=None,
               mu2_initializer=None, mu2_regularizer=None, mu2_constraint=None,
               sigma_initializer=None, sigma_regularizer=None,
               sigma_constraint=None,
               biases_initializer=jax.nn.initializers.zeros,
               biases_regularizer=None, biases_constraint=None,
               dau_unit_border_bound=0.01,
               dau_sigma_trainable=False,
               dau_mu_interpolation=True,
               name=None, **layer_kwargs):
    """Functional wrapper in the style of the reference contrib API
    (dau_conv.py:579-688): layer + optional normalizer + activation.
    Must be called inside a flax module's compact scope. `normalizer_fn`
    receives the pre-activation output (e.g. a flax BatchNorm instance or
    any callable)."""
    use_bias = normalizer_fn is None and biases_initializer is not None
    layer = DAUConv2d(
        filters=filters, dau_units=dau_units, max_kernel_size=max_kernel_size,
        strides=stride, data_format=data_format, activation=None,
        use_bias=use_bias,
        weight_initializer=weights_initializer,
        weight_regularizer=weights_regularizer,
        weight_constraint=weights_constraint,
        mu1_initializer=mu1_initializer, mu2_initializer=mu2_initializer,
        mu1_regularizer=mu1_regularizer, mu1_constraint=mu1_constraint,
        mu2_regularizer=mu2_regularizer, mu2_constraint=mu2_constraint,
        sigma_initializer=sigma_initializer,
        sigma_regularizer=sigma_regularizer,
        sigma_constraint=sigma_constraint,
        bias_initializer=biases_initializer,
        bias_regularizer=biases_regularizer,
        bias_constraint=biases_constraint,
        mu_learning_rate_factor=mu_learning_rate_factor,
        dau_unit_border_bound=dau_unit_border_bound,
        dau_sigma_trainable=dau_sigma_trainable,
        dau_mu_interpolation=dau_mu_interpolation,
        name=name, **layer_kwargs)
    out = layer(inputs)
    if normalizer_fn is not None:
        out = normalizer_fn(out, **(normalizer_params or {}))
    if activation_fn is not None:
        out = activation_fn(out)
    return out


def dau_conv1d(inputs, filters, dau_units, max_kernel_size, *,
               dau_aggregation_forbid_positive_dim1=False, **kwargs):
    """1D variant of `dau_conv2d` (reference dau_conv.py:691-795)."""
    use_bias = kwargs.pop("normalizer_fn", None) is None
    activation_fn = kwargs.pop("activation_fn", nn.relu)
    layer = DAUConv1d(
        filters=filters, dau_units=dau_units, max_kernel_size=max_kernel_size,
        use_bias=use_bias,
        dau_aggregation_forbid_positive_dim1=dau_aggregation_forbid_positive_dim1,
        activation=None, **kwargs)
    out = layer(inputs)
    if activation_fn is not None:
        out = activation_fn(out)
    return out
