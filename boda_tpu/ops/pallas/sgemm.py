"""SGEMM kernel template: the matmul that XLA hands to cuBLAS.

Reference parity: the sgemm CUCL family (test/rtc/sgemm.cucl — register-tiled
Mg:Ng:Mb:Nb:Kb:Mt:Nt blocking) and the cuBLAS comparison path
(culibs-wrap.cc `cublas_sgemm`). A hand-blocked Pallas (Triton-route)
version lost end to end on the H100 (PERF.md), so the matmul is plain
`jnp.dot` under jit and the vendor library does the blocking.

Tunables (kept in the reduced signature, so tuned instances cache separately):
  prec=bf16  — cast inputs to bf16 (f32 accumulate)
"""

from __future__ import annotations

import numpy as np

from ...core.dims import Dims
from ..op_base import OpBase
from ..precision import dot_precision
from ..registry import IN, OUT, KernelTemplate, adecl, template


def _mnk(rfs: OpBase) -> tuple[int, int, int]:
    a = rfs.get_dims("a")
    b = rfs.get_dims("b")
    return a["M"], b["N"], a["K"]


def matmul_epilogue(in_dtype="float32", out_dtype="float32",
                    relu: bool = False, bias: bool = False):
    """f(a[M,K], b[K,N][, bias[N]]) -> c[M,N]: `in_dtype` operands, f32
    accumulation, fused bias + ReLU epilogue (the reference's
    store-with-bias+ReLU fusion, cnn_codegen.cc stores), one store in
    `out_dtype`."""
    import jax.numpy as jnp

    def fn(a, b, bias_vec=None):
        a = a.astype(in_dtype)
        b = b.astype(in_dtype)
        c = jnp.dot(a, b, preferred_element_type=jnp.float32,
                    precision=dot_precision(a.dtype))
        if bias and bias_vec is not None:
            c = c + bias_vec.reshape(1, -1).astype(jnp.float32)
        if relu:
            c = jnp.maximum(c, 0)
        return c.astype(out_dtype)
    return fn


@template
class Sgemm(KernelTemplate):
    """Vendor-library matmul (reference: sgemm.cucl family, culibs-wrap
    cublas_sgemm): stock jnp.dot under jit."""

    name = "sgemm"
    args = [adecl("a", IN, "M K"), adecl("b", IN, "K N"), adecl("c", OUT, "M N")]
    sig_str_keys = ["prec"]

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        M, N, K = _mnk(rfs)
        return 2 * M * N * K

    @classmethod
    def build(cls, rfs: OpBase):
        in_dt = "bfloat16" if rfs.str_vals.get("prec") == "bf16" \
            else str(rfs.get_dims("a").dtype)
        return matmul_epilogue(in_dt, str(rfs.get_dims("c").dtype))

    @classmethod
    def ref_impl(cls, rfs: OpBase, a, b):
        return np.asarray(a, np.float64) @ np.asarray(b, np.float64)


def make_sgemm_op(M: int, N: int, K: int, func_name: str = "sgemm",
                  tn: str = "float") -> OpBase:
    op = OpBase({"type": "sgemm", "func_name": func_name})
    op.set_dims("a", Dims.make(tn=tn, M=M, K=K))
    op.set_dims("b", Dims.make(tn=tn, K=K, N=N))
    op.set_dims("c", Dims.make(tn=tn, M=M, N=N))
    return op
