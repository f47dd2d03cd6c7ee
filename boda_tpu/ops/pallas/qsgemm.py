"""int8 quantized matmul: the extension of the reference's fixed-point
quantization investigation (quantize.cucl + per-layer quantize hooks,
rtc_fwd.cc:28-37; doc/quant_notes.txt).

The reference quantized activations to explore reduced-precision error;
here the capability is a real int8 matmul: symmetric max-abs per-tensor
quantization of both operands, an int8 x int8 -> int32 dot (which XLA
hands to cuBLASLt on the GPU), and an f32 dequantization epilogue.
Selected via OpTune(prec=int8) on sgemm-shaped ops.
"""

from __future__ import annotations

import numpy as np

from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template
from .sgemm import _mnk


def _quant_sym(v, dtype=np.int8):
    """Symmetric max-abs quantization: (q, scale) with v ~ q * scale."""
    amax = np.abs(v).max() or 1.0
    scale = amax / 127.0
    q = np.clip(np.round(v / scale), -127, 127).astype(dtype)
    return q, np.float32(scale)


@template
class SgemmInt8(KernelTemplate):
    """C = dequant(quant8(A) @ quant8(B)): int8 matmul with on-the-fly
    symmetric quantization of f32 inputs."""

    name = "sgemm_int8"
    args = [adecl("a", IN, "M K"), adecl("b", IN, "K N"),
            adecl("c", OUT, "M N")]

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        M, N, K = _mnk(rfs)
        return 2 * M * N * K

    @classmethod
    def build(cls, rfs: OpBase):
        import jax
        import jax.numpy as jnp

        def qsym(v):
            amax = jnp.maximum(jnp.abs(v).max(), 1e-30)
            scale = amax / 127.0
            q = jnp.clip(jnp.round(v / scale), -127, 127).astype(jnp.int8)
            return q, scale.astype(jnp.float32)

        def fn(a, b):
            qa, sa = qsym(a)
            qb, sb = qsym(b)
            acc = jax.lax.dot_general(
                qa, qb, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)
            return acc.astype(jnp.float32) * (sa * sb)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, a, b):
        qa, sa = _quant_sym(np.asarray(a, np.float32))
        qb, sb = _quant_sym(np.asarray(b, np.float32))
        acc = qa.astype(np.int64) @ qb.astype(np.int64)
        return (acc.astype(np.float64) * (float(sa) * float(sb))).astype(np.float32)
