"""Shared GPU edge-gradient shim rule (single source of truth).

The reference's CUDA backward kernel drops gradient contributions from the
last output row/column when the output size divides its tile size
(``ignore_edge_gradients``, dau_conv_backward_core.hpp:2477-2560); its test
oracle replicates that artifact under ``unit_testing``
(dau_conv_test.py:107-136). The XLA engines have no tiles and match the
oracle everywhere, so this rule exists ONLY so differential tests can
compare against the reference semantics bit-for-bit. One helper feeds the
jax op, the numpy oracle, and the native C++ oracle - they must never
drift apart.
"""

from __future__ import annotations

__all__ = ["disabled_edges", "zero_edge_rows_inplace"]

_TILE_SIZES = (64, 32, 16, 8)


def _disable(dim: int) -> bool:
    for tile in _TILE_SIZES:
        if dim >= tile:
            return dim % tile == 0
    return False


def disabled_edges(h: int, w: int):
    """(zero_last_row, zero_last_col) per the reference GPU tile rule."""
    return _disable(h), _disable(w)


def zero_edge_rows_inplace(err) -> None:
    """Zero the disabled last row/col of an (..., H, W) numpy array in place."""
    h, w = err.shape[-2:]
    zero_row, zero_col = disabled_edges(h, w)
    if zero_col:
        err[..., :, w - 1] = 0.0
    if zero_row:
        err[..., h - 1, :] = 0.0
