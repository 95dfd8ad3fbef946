"""Shared-displacement DAU convolution (extension beyond the reference).

Displacements (mu1, mu2) are shared across output channels - per
(input-channel s, unit g) instead of per (s, g, f). This shrinks the
displacement parameter count by F and often regularizes training; the
numerics are exactly `dau_conv2d_op` with mu broadcast over F.

Implementation note: the factorization this sharing enables -

    blur -> per-(s,g) depthwise 4-tap shift -> 1x1 mixing GEMM

has conv3x3-class FLOPs (4G per (s,f,px) instead of ks^2), but runs the
shift as a grouped/depthwise op. This op simply broadcasts into the
standard engine; the gradient of the broadcast sums the per-f mu
gradients, which is the exact adjoint of sharing.
"""

from __future__ import annotations

import jax.numpy as jnp

from .dau_conv import DAUConvSettings, dau_conv2d_op

__all__ = ["dau_conv2d_shared_op"]


def dau_conv2d_shared_op(cfg: DAUConvSettings, x, w, mu1, mu2, sigma):
    """Shared-displacement DAU convolution.

    Args:
      cfg: static DAUConvSettings.
      x: (N, S, H, W). w: (S, G, F). mu1, mu2: (S, G). sigma: broadcastable
        scalar.

    Returns: (N, F, H, W); gradients of mu1/mu2 have shape (S, G) (the per-f
    gradients of the underlying op, summed over F by the broadcast adjoint).
    """
    s, g, f = w.shape
    mu1b = jnp.broadcast_to(mu1[:, :, None], (s, g, f))
    mu2b = jnp.broadcast_to(mu2[:, :, None], (s, g, f))
    return dau_conv2d_op(cfg, x, w, mu1b, mu2b, sigma)
