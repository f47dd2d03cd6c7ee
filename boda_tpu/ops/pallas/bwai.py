"""bwai: bandwidth-and-issue micro-benchmark template.

Reference parity: test/rtc/bwai.cucl (the reference's raw memory-bandwidth
probe, profiled via ops_prof like any other op) and the mxplusb smoke
kernel family. Roles:

  op=copy   — out[i] = in[i]: HBM read+write streaming rate
  op=scale  — out[i] = in[i]*a + b: adds ALU work to the stream (mxplusb)
  op=read   — out[0] = sum(in): read-only rate (the reduce defeats DCE)

Timed through ops_prof's chained slope methodology these give the honest
achievable HBM rates that whole-net roofline analysis needs (not
measured on the GPU yet). Keeping it as a KernelTemplate means the same
sweep/wisdom/digest
machinery covers it.
"""

from __future__ import annotations

import numpy as np

from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template


@template
class Bwai(KernelTemplate):
    name = "bwai"
    args = [adecl("in", IN, "n"), adecl("out", OUT, "n")]
    sig_str_keys = ["bw_op"]
    sig_nda_keys = ["a", "b"]

    @classmethod
    def _params(cls, rfs: OpBase):
        op = rfs.str_vals.get("bw_op", "copy")
        a = float(rfs.nda_vals["a"].item()) if "a" in rfs.nda_vals else 2.0
        b = float(rfs.nda_vals["b"].item()) if "b" in rfs.nda_vals else 1.0
        return op, a, b

    @classmethod
    def build(cls, rfs: OpBase):
        import jax.numpy as jnp
        op, a, b = cls._params(rfs)
        n_out = rfs.get_dims("out")["n"]
        if op == "copy":
            return lambda x: x + 0  # materialized copy (not aliased)
        if op == "scale":
            return lambda x: x * x.dtype.type(a) + x.dtype.type(b)
        if op == "read":
            # out is TINY (op files use n=8): a full-size output would
            # write n elements back and double the 'read-only' traffic
            # (ADVICE r2). The sum consumes every element so XLA cannot
            # dead-code the read.
            def fn(x):
                s = jnp.sum(x.astype(jnp.float32)).astype(x.dtype)
                return jnp.zeros((n_out,), x.dtype).at[0].set(s)
            return fn
        raise ValueError(f"bwai: unknown bw_op '{op}'")

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        op, a, b = cls._params(rfs)
        x = np.asarray(x)
        if op == "copy":
            return x.copy()
        if op == "scale":
            return (x * x.dtype.type(a) + x.dtype.type(b)).astype(x.dtype)
        out = np.zeros(rfs.get_dims("out")["n"], x.dtype)
        out[0] = x.astype(np.float64).sum().astype(x.dtype)
        return out

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        op, _a, _b = cls._params(rfs)
        n = rfs.get_dims("in")["n"]
        return {"copy": 0, "scale": 2 * n, "read": n}[op]

    @classmethod
    def bytes_accessed(cls, rfs: OpBase) -> int:
        op, _a, _b = cls._params(rfs)
        d = rfs.get_dims("in")
        isz = np.dtype(d.dtype).itemsize
        n = d["n"]
        if op == "read":
            od = rfs.get_dims("out")
            return n * isz + od["n"] * np.dtype(od.dtype).itemsize
        return 2 * n * isz
