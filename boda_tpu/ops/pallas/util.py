"""Shared template helpers: storage-layout conventions."""

from __future__ import annotations


def storage_io(rfs):
    """(io_nhwc, edge_dtype_or_None) from a reduced sig.

    The fused-storage pass (engine/lower.py) marks every step with
    io_layout=nhwc (+ edge_prec=bf16 under prec=bf16): templates then
    consume/produce NHWC storage tensors directly — no per-op wrapping
    transposes — and keep inter-op edges in the compute dtype (one HBM
    round-trip in bf16 instead of f32: ResNet-50 is HBM-bound, so edge
    storage is the dominant whole-net cost)."""
    import jax.numpy as jnp
    nhwc = rfs.str_vals.get("io_layout") == "nhwc"
    edt = jnp.bfloat16 if rfs.str_vals.get("edge_prec") == "bf16" else None
    return nhwc, edt
