"""Flax-free functional core of the DAU layer.

Everything the layer means, apart from the module system: parameter
initialization (reference `DAUGridMean` / `ZeroNLast`, normal(0.1) weights,
the shared sigma), the unit rounding to groups of 2 with dummy units, the
layer-level mu clip, the sigma handling, stride emulation, bias and
activation around `dau_conv2d_op`, and the post-update projection
`project_dau_params`. Reference: plugins/tensorflow/dau_conv/dau_conv.py
(`DAUConv2d` :221-555, `DAUGridMean` :24-74, `ZeroNLast` :76-110).

`DAULayer` is a static (hashable) description of one layer with
`init(rng, in_channels)` and `apply(params, x)`; the models in
`dau_convnet.models.alexnet` are written on it, and the flax modules in
`dau_convnet.nn.layers` are thin wrappers over it. Only JAX and numpy are
imported here.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.dau_conv import (DAUConvSettings, dau_conv2d_infer, dau_conv2d_op,
                            precompute_phi)
from ..ops.gaussian import blur_kernel_size

__all__ = ["DAULayer", "DAUGridMean", "ZeroNLast", "DAU_UNITS_GROUP",
           "project_dau_params", "set_dau_variables_manually",
           "rounded_units"]

# the engine aggregates units in groups of 2; odd unit counts get one dummy
# unit with zero weight and no gradient (reference dau_conv.py:223-224,
# :313-329). Kept for layout/checkpoint parity with the reference.
DAU_UNITS_GROUP = 2

# the reference's own blur-filter hard limit (17x17 filter, convolve.cu:40)
_DEFAULT_SIGMA_MAX = 1.6


def DAUGridMean(dau_units, max_value, dau_unit_axis=2):
    """Initializer spreading DAU means on a regular grid in [-max, +max].

    Reference dau_conv.py:24-74. For the requested shape [1, S, G, F] with
    G = prod(dau_units) (+ dummy pad), positions vary along unit axis
    `dau_unit_axis` of the separated [S, units0, units1, F] view (2 => mu1,
    1 => mu2) and broadcast along all other axes.
    """
    u0, u1 = dau_units

    def init(key, shape, dtype=jnp.float32):
        del key
        if len(shape) != 4:
            raise ValueError(
                "DAUGridMean requires rank-4 shape [1, S, units, F]")
        _, s, g, f = shape
        sep = (u0, u1) if g == u0 * u1 else None
        if sep is None:
            # dummy-padded unit count: spread over the flat G axis instead
            n = g
            vals = (np.arange(n) * (2 * max_value + 1) / float(n)
                    + (-0.5 + (2 * max_value + 1) / float(2 * n)) - max_value)
            out = np.broadcast_to(vals[None, None, :, None], (1, s, g, f))
            return jnp.asarray(out, dtype)
        n = (u0, u1)[dau_unit_axis - 1]
        vals = (np.arange(n) * (2 * max_value + 1) / float(n)
                + (-0.5 + (2 * max_value + 1) / float(2 * n)) - max_value)
        grid = np.zeros((1, s, u0, u1, f))
        if dau_unit_axis == 2:
            grid += vals[None, None, None, :, None]
        elif dau_unit_axis == 1:
            grid += vals[None, None, :, None, None]
        else:
            raise ValueError("dau_unit_axis must be 1 (mu2) or 2 (mu1)")
        return jnp.asarray(grid.reshape(1, s, g, f), dtype)

    return init


def ZeroNLast(base_init, last_num_to_zero, axis):
    """Wrap an initializer, zeroing the last N entries along `axis`
    (reference dau_conv.py:76-110; used to blank dummy units' weights)."""

    def init(key, shape, dtype=jnp.float32):
        vals = base_init(key, shape, dtype)
        if last_num_to_zero == 0:
            return vals
        idx = jnp.arange(shape[axis]) < (shape[axis] - last_num_to_zero)
        bshape = [1] * len(shape)
        bshape[axis] = shape[axis]
        return vals * idx.reshape(bshape).astype(dtype)

    return init


def rounded_units(dau_units: tp.Tuple[int, int]):
    """Round the unit count up to a multiple of DAU_UNITS_GROUP, growing the
    smaller grid axis (reference dau_conv.py:313-329). Returns
    (dau_units, num_all, num_ignore)."""
    units = tuple(int(u) for u in dau_units)
    num_all = int(np.prod(units))
    num_ignore = 0
    if num_all % DAU_UNITS_GROUP != 0:
        new_num = int(math.ceil(num_all / DAU_UNITS_GROUP) * DAU_UNITS_GROUP)
        num_ignore = new_num - num_all
        if units[0] < units[1]:
            units = (units[0] + num_ignore, units[1])
        else:
            units = (units[0], units[1] + num_ignore)
        num_all = new_num
    return units, num_all, num_ignore


@dataclasses.dataclass(frozen=True)
class DAULayer:
    """One Displaced Aggregation Unit 2D convolution layer, as static data.

    Field names and defaults follow the reference `DAUConv2d`
    (dau_conv.py:221-555, README.md:150-190). Input is NCHW for
    data_format='channels_first' (reference behavior) or NHWC for
    'channels_last' (extension). Parameters: weights/mu1/mu2 of shape
    [1, S, G, F], sigma of shape [1] (single shared Gaussian width,
    trainable only when `dau_sigma_trainable`), and bias [F].
    """

    filters: int
    dau_units: tp.Tuple[int, int]
    max_kernel_size: int
    strides: int = 1
    data_format: str = "channels_first"
    use_bias: bool = True
    mu_learning_rate_factor: float = 500.0
    dau_unit_border_bound: float = 0.01
    dau_unit_single_dim: bool = False
    dau_aggregation_forbid_positive_dim1: bool = False
    dau_sigma_trainable: bool = False
    dau_mu_interpolation: bool = True
    dau_sigma_init: float = 0.5
    # Largest sigma a trainable sigma may grow to: sizes the static blur
    # filter generously up front (the reference re-sizes its filter whenever
    # sigma changes, base_dau_conv_layer.cpp:146-158; under jit the size is
    # static, and the op clips sigma to the filter's support). None = the
    # reference's own 17x17-filter hard limit (sigma 1.6) when trainable,
    # else just dau_sigma_init.
    dau_sigma_max: tp.Optional[float] = None
    unit_testing: bool = False
    # Static promise that |mu| stays <= this bound: shrinks the synthesized
    # aggregation kernel to the matching tier and clips mu accordingly.
    # Trace-time replacement for the reference's per-step amax(mu)
    # kernel-tier dispatch (dau_conv_op.cpp:223-256); see
    # utils.tiers.tier_for_params for the between-epochs re-jit workflow.
    # None = derive from max_kernel_size.
    static_max_offset: tp.Optional[float] = None
    # 'auto' (default): resolved by DAUConvSettings - fourier for the
    # production bf16 path, xla for f32/'highest' (the oracle-exact mode)
    engine: str = "auto"
    # rebuild the fourier phase table in the backward instead of stashing
    # it as a residual (activation-memory saver for large-batch training)
    remat_phi: bool = False
    # None = auto: 'highest' (oracle-exact f32) for float32, 'default'
    # otherwise
    precision: tp.Optional[str] = None
    dtype: tp.Any = jnp.float32

    # ---- static shape/config derivations ---------------------------------

    @property
    def unit_info(self):
        """(dau_units, num_all, num_ignore) after rounding to groups of 2."""
        return rounded_units(tuple(self.dau_units))

    @property
    def channels_last(self) -> bool:
        return self.data_format in ("channels_last", "NHWC")

    def param_shape(self, in_channels: int):
        return (1, in_channels, self.unit_info[1], self.filters)

    def sigma_cap(self) -> float:
        """Largest sigma this layer's static blur filter must support."""
        if not self.dau_sigma_trainable:
            return self.dau_sigma_init
        cap = _DEFAULT_SIGMA_MAX if self.dau_sigma_max is None else self.dau_sigma_max
        return max(self.dau_sigma_init, cap)

    @property
    def mu_bound(self) -> float:
        """Layer-level clip keeping units inside the kernel (reference
        dau_conv.py:183,188-195); a static_max_offset tier promise tightens
        it so it is always safe."""
        bound = math.floor(self.max_kernel_size / 2.0) - self.dau_unit_border_bound
        if self.static_max_offset is not None:
            bound = min(bound, self.static_max_offset)
        return bound

    def settings(self) -> DAUConvSettings:
        precision = self.precision
        if precision is None:
            precision = ("highest" if jnp.dtype(self.dtype) == jnp.float32
                         else "default")
        return DAUConvSettings(
            kernel_size=self.max_kernel_size,
            use_interpolation=self.dau_mu_interpolation,
            number_units_ignore=self.unit_info[2],
            single_dim_kernel=self.dau_unit_single_dim,
            forbid_positive_dim1=self.dau_aggregation_forbid_positive_dim1,
            mu_learning_rate_factor=self.mu_learning_rate_factor,
            component_border_bound=self.dau_unit_border_bound,
            unit_testing=self.unit_testing,
            blur_size=blur_kernel_size(self.sigma_cap()),
            compute_sigma_grad=self.dau_sigma_trainable,
            static_max_offset=self.static_max_offset,
            engine=self.engine,
            precision=precision,
            remat_phi=self.remat_phi,
        )

    # ---- parameters -------------------------------------------------------

    def initializers(self, *, weights=None, mu1=None, mu2=None, sigma=None,
                     bias=None):
        """The layer's parameter initializers by name; any argument given
        replaces that default (weights are always dummy-unit masked)."""
        units, _, num_ignore = self.unit_info
        max_val = math.floor(self.max_kernel_size / 2.0) - 1
        w_base = weights or jax.nn.initializers.normal(stddev=0.1)
        default_mu2 = (jax.nn.initializers.zeros if self.dau_unit_single_dim
                       else DAUGridMean(units, max_val, dau_unit_axis=1))
        return {
            "weights": ZeroNLast(w_base, num_ignore, axis=2),
            "mu1": mu1 or DAUGridMean(units, max_val, dau_unit_axis=2),
            "mu2": mu2 or default_mu2,
            "sigma": sigma or jax.nn.initializers.constant(self.dau_sigma_init),
            "bias": bias or jax.nn.initializers.zeros,
        }

    def init(self, rng, in_channels: int):
        """Fresh parameters {weights, mu1, mu2, sigma[, bias]}."""
        inits = self.initializers()
        pshape = self.param_shape(in_channels)
        shapes = {"weights": pshape, "mu1": pshape, "mu2": pshape,
                  "sigma": (1,)}
        if self.use_bias:
            shapes["bias"] = (self.filters,)
        keys = jax.random.split(rng, len(shapes))
        return {name: inits[name](k, shape, self.dtype)
                for k, (name, shape) in zip(keys, shapes.items())}

    def effective_params(self, params):
        """(w, mu1, mu2, sigma) as the op sees them: sigma frozen or clipped,
        mu2 pinned for 1D units, mu clipped to the layer bound."""
        w, mu1, mu2, sigma = (params[k] for k in ("weights", "mu1", "mu2",
                                                 "sigma"))
        if not self.dau_sigma_trainable:
            sigma = jax.lax.stop_gradient(sigma)
        else:
            # In-graph clip, like mu below: the op clips the EFFECTIVE
            # sigma, but its analytic VJP returns the gradient
            # unconditionally, so without this the raw param drifts
            # unbounded past the floor. The clip's autodiff zeroes the
            # out-of-range gradient - the layer analogue of the reference's
            # in-place param bounds guard (base_dau_conv_layer.cu:33-49).
            sigma = jnp.clip(sigma, DAUConvSettings.sigma_lower_bound,
                             self.sigma_cap())
        if self.dau_unit_single_dim:
            # 1D DAU: mu2 pinned at zero (reference mu2 zero-constraint,
            # dau_conv.py:562-563).
            mu2 = jnp.zeros_like(mu2)
        bound = self.mu_bound
        return (w, jnp.clip(mu1, -bound, bound), jnp.clip(mu2, -bound, bound),
                sigma)

    def build_phi(self, params, spatial, dtype=None):
        """Serving: the fourier phase table for frozen `params` at input
        spatial shape (H, W) - pass it to `apply(..., phi=...)`. None for
        the dense engine, which has no table."""
        cfg = self.settings()
        if cfg.engine != "fourier":
            return None
        w, mu1, mu2, _ = self.effective_params(params)
        dtype = self.dtype if dtype is None else dtype
        return precompute_phi(cfg, tuple(spatial), w.astype(dtype), mu1, mu2)

    # ---- the layer ---------------------------------------------------------

    def apply(self, params, inputs, *, phi=None, activation=None):
        """The layer on `inputs` (rank 4, per `data_format`). With `phi`
        (from `build_phi`) the forward skips the phase-table build and
        carries no w/mu gradients: the serving path."""
        if inputs.ndim != 4:
            raise ValueError(f"DAU layer expects rank-4 input, got {inputs.shape}")
        x = jnp.transpose(inputs, (0, 3, 1, 2)) if self.channels_last else inputs
        cfg = self.settings()
        w, mu1, mu2, sigma = self.effective_params(params)
        sigma_tiled = jnp.broadcast_to(sigma.reshape(1, 1, 1, 1), w.shape)
        if phi is not None:
            out = dau_conv2d_infer(cfg, x, w, mu1, mu2, sigma_tiled, phi=phi)
        else:
            out = dau_conv2d_op(cfg, x, w, mu1, mu2, sigma_tiled)

        if self.strides > 1:
            # stride emulated by output slicing, same compute as stride 1
            # (reference dau_conv.py:339-342,496-498)
            out = out[:, :, ::self.strides, ::self.strides]
        if self.use_bias:
            out = out + params["bias"].reshape(1, self.filters, 1, 1)
        if activation is not None:
            out = activation(out)
        return jnp.transpose(out, (0, 2, 3, 1)) if self.channels_last else out


def project_dau_params(params, *, kernel_size: int,
                       component_border_bound: float = 0.01,
                       sigma_lower_bound: float = 0.3,
                       sigma_upper_bound: float = 1.6):
    """Project DAU params back into their valid ranges after an optimizer
    update - the functional equivalent of the reference's in-place bounds
    guard (base_dau_conv_layer.cu:33-49), which clips the param STORAGE
    every forward so boundary gradients keep flowing. (The layers also
    clip in-graph, which bounds the EFFECTIVE values but freezes a raw
    param that momentum carried past a bound - with trainable sigma, run
    this on the params after each update.) Clips leaves named 'sigma'
    into [sigma_lower_bound, sigma_upper_bound] and 'mu1'/'mu2' into
    +-(kernel_size//2 - component_border_bound). jit-safe.
    """
    bound = kernel_size // 2 - component_border_bound

    def fix(path, v):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "sigma":
            return jnp.clip(v, sigma_lower_bound, sigma_upper_bound)
        if name in ("mu1", "mu2"):
            return jnp.clip(v, -bound, bound)
        return v

    return jax.tree_util.tree_map_with_path(fix, params)


def set_dau_variables_manually(variables, layer_path: str, *,
                               weights=None, mu1=None, mu2=None,
                               sigma=None, bias=None):
    """Load custom/pretrained DAU parameters into a variables pytree.

    Parity with the reference `DAUConv2d.set_dau_variables_manually`
    (plugins/tensorflow/dau_conv/dau_conv.py:344-359), which replaces the
    layer's TF variables with user-supplied tensors. Parameters are
    external state here, so this returns a NEW pytree with the named
    layer's entries replaced (the input is not mutated).

    Args:
      variables: pytree from `model.init` - either the full
        ``{"params": {...}}`` dict or the inner params dict.
      layer_path: the layer's name, or a '/'-separated path for nested
        modules (e.g. ``"block1/dau_conv2"``); ``""`` when the layer's
        params are at the root.
      weights, mu1, mu2, sigma, bias: arrays to install (any subset).
        Shapes must match the existing parameters exactly
        (``DAULayer.param_shape``); ``sigma`` additionally accepts a bare
        scalar (the layer stores the single shared sigma as shape ``(1,)``,
        reference dau_conv.py:417-430). Values are cast to the existing
        parameter dtype.

    Returns: a pytree of the same structure with the new values installed.
    """
    def _copy(d):
        # also turns a flax FrozenDict (a Mapping) into nested plain dicts
        return {k: (_copy(v) if hasattr(v, "items") else v)
                for k, v in d.items()}

    root = _copy(variables)
    node = root["params"] if "params" in root and isinstance(root["params"], dict) else root
    path = [p for p in layer_path.split("/") if p]
    for p in path:
        if not isinstance(node, dict) or p not in node:
            raise KeyError(
                f"layer path {layer_path!r} not found (missing {p!r}); "
                f"available: {sorted(node) if isinstance(node, dict) else node}")
        node = node[p]

    updates = {"weights": weights, "mu1": mu1, "mu2": mu2,
               "sigma": sigma, "bias": bias}
    for name, value in updates.items():
        if value is None:
            continue
        if name not in node:
            raise KeyError(
                f"layer {layer_path!r} has no parameter {name!r} "
                f"(has {sorted(node)})")
        old = node[name]
        new = jnp.asarray(value, dtype=old.dtype)
        if name == "sigma" and new.ndim == 0:
            new = new.reshape(old.shape)
        if new.shape != old.shape:
            raise ValueError(
                f"{layer_path}/{name}: shape {new.shape} != expected "
                f"{old.shape} (DAU params are [1, S, G, F]; sigma is (1,))")
        node[name] = new
    return root
