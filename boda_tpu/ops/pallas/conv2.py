"""xla_conv2: horizontally-fused sibling convolutions.

An addition (no CUDA analog; the reference's closest idea is
the k1conv write-xpose chaining, rtc_fwd.cc:495-503): two convolutions
that share the SAME input and stride — the branch1 projection +
branch2a reduce pair at every ResNet stage boundary, googlenet
inception 1x1 trios, squeezenet fire expand1x1+expand3x3 pairs — run
as ONE conv whose filters are concatenated on out_chan, then split.
Kernel sizes may differ when (2*pad - kern) matches per axis: the
smaller kernel is zero-padded to the center of the group max (exact
arithmetic — a 1x1 pad-0 conv IS a 3x3 pad-1 conv with one live tap).
Why it can win: the siblings' N dims are narrow (64/256 at res2a) and
each standalone conv re-reads the full input from HBM; fused, N widens
and the input streams once.

Per-sibling ReLU flags are preserved (branch1 has no ReLU, branch2a
does). Selected by the `fuse_siblings` lowering pass (engine/lower.py),
gated by OpTune(fuse_siblings=1).
"""

from __future__ import annotations

import numpy as np

from ...core.dims import Dims
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template
from .conv import _quantize_conv_operands


SIBS = ("a", "b", "c", "d")   # up to 4-way fusion (inception blocks)


@template
class XlaConv2(KernelTemplate):
    name = "xla_conv2"
    nhwc_ok = True
    args = [adecl("in", IN, "img chan y x"),
            adecl("filts_a", IN, "out_chan in_chan y x"),
            adecl("biases_a", IN, "out_chan", opt=True),
            # *_scale: per-out_chan dequant scales set by the weight-
            # prequantization pass (engine/lower.py) — filts arrive int8
            adecl("filts_a_scale", IN, "out_chan", opt=True),
            adecl("filts_b", IN, "out_chan in_chan y x"),
            adecl("biases_b", IN, "out_chan", opt=True),
            adecl("filts_b_scale", IN, "out_chan", opt=True),
            adecl("filts_c", IN, "out_chan in_chan y x", opt=True),
            adecl("biases_c", IN, "out_chan", opt=True),
            adecl("filts_c_scale", IN, "out_chan", opt=True),
            adecl("filts_d", IN, "out_chan in_chan y x", opt=True),
            adecl("biases_d", IN, "out_chan", opt=True),
            adecl("filts_d_scale", IN, "out_chan", opt=True),
            adecl("out_a", OUT, "img chan y x"),
            adecl("out_b", OUT, "img chan y x"),
            adecl("out_c", OUT, "img chan y x", opt=True),
            adecl("out_d", OUT, "img chan y x", opt=True)]
    sig_nda_keys = ["in_pad", "stride", "kern_sz", "relu_a", "relu_b",
                    "relu_c", "relu_d", "quant8", "act_scale", "prequant_w",
                    "grad_q8"]
    sig_str_keys = ["prec", "layout"]

    @classmethod
    def _sibs(cls, rfs: OpBase):
        return [s for s in SIBS if f"filts_{s}" in rfs.nda_vals]

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        tot = 0
        for s in cls._sibs(rfs):
            f = rfs.get_dims(f"filts_{s}")
            tot += 2 * rfs.get_dims(f"out_{s}").sz() * f["in_chan"] \
                * f["y"] * f["x"]
        return tot

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, *wbs):
        from .conv import _ConvBase
        sibs = cls._sibs(rfs)
        if rfs.get_u32_or("prequant_w", 0):
            # (w, b, scale) triplets: dequantize back to float pairs
            ws = [np.asarray(wbs[3 * i], np.float64)
                  * np.asarray(wbs[3 * i + 2], np.float64
                               ).reshape(-1, 1, 1, 1)
                  for i in range(len(sibs))]
            wbs = [v for i in range(len(sibs))
                   for v in (ws[i], wbs[3 * i + 1])]
        fds = [rfs.get_dims(f"filts_{s}") for s in sibs]
        ky_f = max(d["y"] for d in fds)
        kx_f = max(d["x"] for d in fds)
        pd = rfs.get_dims_or_none("in_pad")
        py_f, px_f = (pd["y"], pd["x"]) if pd is not None else (0, 0)
        outs = []
        for i, s in enumerate(sibs):
            sr = OpBase({"type": "Convolution"})
            sr.nda_vals["in"] = rfs.nda_vals["in"]
            sr.nda_vals["filts"] = rfs.nda_vals[f"filts_{s}"]
            sr.nda_vals["out"] = rfs.nda_vals[f"out_{s}"]
            if "stride" in rfs.nda_vals:
                sr.nda_vals["stride"] = rfs.nda_vals["stride"]
            # per-sibling pad: fused pad minus this kernel's embed margin
            py_i = py_f - (ky_f - fds[i]["y"]) // 2
            px_i = px_f - (kx_f - fds[i]["x"]) // 2
            if py_i or px_i:
                sr.set_null_dims("in_pad", y=py_i, x=px_i)
            if rfs.get_u32_or(f"relu_{s}", 0):
                sr.set_u32("conv_has_relu", 1)
            outs.append(_ConvBase.ref_impl(sr, x, wbs[2 * i], wbs[2 * i + 1]))
        return tuple(outs)

    @classmethod
    def build(cls, rfs: OpBase):
        import jax
        import jax.numpy as jnp

        from .util import storage_io
        sibs = cls._sibs(rfs)
        st = rfs.get_dims_or_none("stride")
        pad = rfs.get_dims_or_none("in_pad")
        sy, sx = (st["y"], st["x"]) if st else (1, 1)
        py, px = (pad["y"], pad["x"]) if pad else (0, 0)
        fds = [rfs.get_dims(f"filts_{s}") for s in sibs]
        ky_f = max(d["y"] for d in fds)
        kx_f = max(d["x"] for d in fds)
        embeds = [((ky_f - d["y"]) // 2, (kx_f - d["x"]) // 2) for d in fds]
        ns = [d["out_chan"] for d in fds]
        relus = [rfs.get_u32_or(f"relu_{s}", 0) == 1 for s in sibs]
        out_dts = [rfs.get_dims(f"out_{s}").dtype for s in sibs]
        bf16 = rfs.str_vals.get("prec") == "bf16"
        quant8 = rfs.get_u32_or("quant8", 0) == 1
        grad_q8 = rfs.get_u32_or("grad_q8", 0) == 1
        prequant = rfs.get_u32_or("prequant_w", 0) == 1
        act_absmax = float(rfs.nda_vals["act_scale"].item()) \
            if "act_scale" in rfs.nda_vals else 0.0
        io_nhwc, edt = storage_io(rfs)
        cdt = jnp.bfloat16 if bf16 else jnp.float32
        if io_nhwc and edt is not None:
            out_dts = [edt] * len(sibs)

        def fn(x, *wbs):
            if prequant:
                # (wq, b, sws) triplets (lower.py prequant pass): only the
                # activation quantizes in-program. Embedding pads int8
                # zeros — exact, same as zero float taps.
                wq_l, b_l, sw_l = wbs[0::3], wbs[1::3], wbs[2::3]
                ws = [jnp.pad(w_i, ((0, 0), (0, 0), (dy, dy), (dx, dx)))
                      if (dy or dx) else w_i
                      for w_i, (dy, dx) in zip(wq_l, embeds)]
                wq = jnp.transpose(jnp.concatenate(ws, axis=0), (2, 3, 1, 0))
                b = jnp.concatenate(b_l, axis=0)
                sws = jnp.concatenate(sw_l, axis=0)
                xh = x if io_nhwc else jnp.transpose(x, (0, 2, 3, 1))
                xf = xh.astype(jnp.float32)
                # s_act, NOT sx: the stride sx is in scope
                s_act = jnp.float32(act_absmax / 127.0) if act_absmax else \
                    jnp.max(jnp.abs(xf)) / 127.0 + 1e-30
                xq = jnp.clip(jnp.round(xf / s_act),
                              -127, 127).astype(jnp.int8)
                y = jax.lax.conv_general_dilated(
                    xq, wq, window_strides=(sy, sx),
                    padding=((py, py), (px, px)),
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                    preferred_element_type=jnp.int32)
                y = y.astype(jnp.float32) * (s_act * sws)[None, None, None, :]
                y = y + b.astype(y.dtype)[None, None, None, :]
                outs = []
                off = 0
                for n_i, relu_i, dt_i in zip(ns, relus, out_dts):
                    yi = y[..., off:off + n_i]
                    off += n_i
                    if relu_i:
                        yi = jnp.maximum(yi, 0)
                    if not io_nhwc:
                        yi = jnp.transpose(yi, (0, 3, 1, 2))
                    outs.append(yi.astype(dt_i))
                return tuple(outs)
            # mixed kernel sizes: center-embed each smaller kernel in the
            # group max (zero weight taps — exact; squeezenet fire expand
            # 1x1s ride their 3x3 partners' MXU contraction)
            ws = [jnp.pad(w_i, ((0, 0), (0, 0), (dy, dy), (dx, dx)))
                  if (dy or dx) else w_i
                  for w_i, (dy, dx) in zip(wbs[0::2], embeds)]
            w = jnp.concatenate(ws, axis=0)           # (sum(ns), ic, ky, kx)
            b = jnp.concatenate(wbs[1::2], axis=0)
            wh = jnp.transpose(w, (2, 3, 1, 0))
            xh = x if io_nhwc else jnp.transpose(x, (0, 2, 3, 1))
            if quant8:
                xq, wq, sc = _quantize_conv_operands(xh, wh, (0, 1, 2), act_absmax)
                y = jax.lax.conv_general_dilated(
                    xq, wq, window_strides=(sy, sx),
                    padding=((py, py), (px, px)),
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                    preferred_element_type=jnp.int32)
                y = y.astype(jnp.float32) * sc
            else:
                from ..mxu_grad import mxu_conv
                y = mxu_conv(
                    xh, wh, window_strides=(sy, sx),
                    padding=((py, py), (px, px)),
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                    compute_dtype=cdt, wgrad_int8=grad_q8)
            y = y + b.astype(y.dtype)[None, None, None, :]
            outs = []
            off = 0
            for n_i, relu_i, dt_i in zip(ns, relus, out_dts):
                yi = y[..., off:off + n_i]
                off += n_i
                if relu_i:
                    # output-residual epilogue (ops/mxu_grad.relu_store):
                    # bit-identical forward, no f32 residual under grad
                    from ..mxu_grad import relu_store
                    yi = relu_store(yi, dt_i)
                else:
                    yi = yi.astype(dt_i)
                if not io_nhwc:
                    yi = jnp.transpose(yi, (0, 3, 1, 2))
                outs.append(yi)
            return tuple(outs)
        return fn
