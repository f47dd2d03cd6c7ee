"""Matmul/conv precision policy shared by every template and VJP."""

from __future__ import annotations


def dot_precision(dtype):
    """f32 inputs demand full f32 precision; bf16 inputs use the fast
    single-pass default. Without this, 'float32' contractions silently run
    in TF32 on the GPU (about three decimal digits) — the explicit-
    precision-control requirement called out in SURVEY.md §7 hard parts."""
    import jax
    return (jax.lax.Precision.HIGHEST if str(dtype) in ("float32", "float64")
            else jax.lax.Precision.DEFAULT)
