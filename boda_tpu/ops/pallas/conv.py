"""Convolution kernel templates: the conv variant family.

Reference parity: the CUCL conv family (conv.cucl direct smem-tiled,
k1conv.cucl 1×1-as-matmul, tconv.cucl spatial-tiled, ipconv.cucl
inner-product, *_simd flavors) generated by cnn_codegen.cc:165-828 and
selected per shape+tune by cnn_op.cc:46-68, with the cuDNN path
(culibs-wrap.cc `cudnn_conv`) as comparison baseline.

Mapping:
  * `xla_conv`  — lax.conv_general_dilated under jit: the vendor-library
    path (cuDNN): correctness reference and perf target.
  * `k1conv`    — 1×1 conv lowered to the matmul
    (pixels × in_chan) @ (in_chan × out_chan), bias+ReLU fused after it.
  * `conv`      — im2col over the (ky,kx) taps + one matmul.
  * `ipconv`    — InnerProduct (FC): plain matmul with bias+ReLU fusion.

All templates carry the fusion flag `conv_has_relu` in their reduced
signature (reference keeps it sig-relevant, rtc_func_gen.cc:136) and accept
op sigs in the reference layout: in/out NCHW `(img,chan,y,x)`, filts
`(out_chan,in_chan,y,x)`, metadata dims in_pad/stride/kern_sz.
"""

from __future__ import annotations

import numpy as np

from ...core.dims import Dims
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template
from .sgemm import matmul_epilogue


def conv_params(rfs: OpBase):
    ind = rfs.get_dims("in")
    outd = rfs.get_dims("out")
    fd = rfs.get_dims("filts")
    st = rfs.get_dims_or_none("stride")
    pad = rfs.get_dims_or_none("in_pad")
    sy, sx = (st["y"], st["x"]) if st else (1, 1)
    py, px = (pad["y"], pad["x"]) if pad else (0, 0)
    relu = rfs.get_u32_or("conv_has_relu", 0) == 1
    return ind, outd, fd, sy, sx, py, px, relu


def _quantize_conv_operands(x, w, w_chan_axes, act_absmax=0.0):
    """Symmetric int8 quantization: per-tensor activation scale (dynamic
    max, or STATIC when a calibrated act_absmax is given — skips the
    per-call reduction), per-out_chan weight scales. Returns
    (xq, wq, combined_scale) where combined_scale broadcasts over the
    conv output's channel axis."""
    import jax.numpy as jnp
    xf = x.astype(jnp.float32)
    if act_absmax:
        sx = jnp.float32(act_absmax / 127.0)
    else:
        sx = jnp.max(jnp.abs(xf)) / 127.0 + 1e-30
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    wf = w.astype(jnp.float32)
    sw = jnp.max(jnp.abs(wf), axis=w_chan_axes, keepdims=True) / 127.0 + 1e-30
    wq = jnp.clip(jnp.round(wf / sw), -127, 127).astype(jnp.int8)
    return xq, wq, sx * sw


def conv_flops(rfs: OpBase) -> int:
    _ind, outd, fd, *_ = conv_params(rfs)
    return 2 * outd.sz() * fd["in_chan"] * fd["y"] * fd["x"]


class _ConvBase(KernelTemplate):
    args = [adecl("in", IN, "img chan y x"),
            adecl("filts", IN, "out_chan in_chan y x"),
            # set by the weight-prequantization pass (engine/lower.py):
            # filts arrive int8 with this per-out_chan dequant scale
            adecl("filts_scale", IN, "out_chan", opt=True),
            adecl("biases", IN, "out_chan", opt=True),
            adecl("out", OUT, "img chan y x")]
    sig_nda_keys = ["in_pad", "stride", "kern_sz", "conv_has_relu",
                    "quant8", "act_scale", "prequant_w",
                    "in_q8", "out_q8", "out_scale", "grad_q8"]
    sig_str_keys = ["prec", "layout"]

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        return conv_flops(rfs)

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, w, *rest):
        """Direct float64 conv reference (shared by all variants)."""
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        if rfs.get_u32_or("prequant_w", 0):
            # prequantized weights: (x, wq, sws[, b]) — dequantize first
            sws, rest = rest[0], rest[1:]
            w = np.asarray(w, np.float64) \
                * np.asarray(sws, np.float64).reshape(-1, 1, 1, 1)
        b = rest[0] if rest else None
        x = np.asarray(x, np.float64)
        if rfs.get_u32_or("in_q8", 0):
            # int8 storage edge: input arrives quantized at the static
            # act_scale — dequantize (the float quant8 reference runs the
            # conv in float, mirroring the dequant-weights approximation)
            x = x * (float(rfs.nda_vals["act_scale"].item()) / 127.0)
        w = np.asarray(w, np.float64)
        n, C, H, W = x.shape
        oc, ic, ky, kx = w.shape
        oy, ox = outd["y"], outd["x"]
        xp = np.pad(x, ((0, 0), (0, 0), (py, py), (px, px)))
        out = np.zeros((n, oc, oy, ox))
        for yy in range(ky):
            for xx in range(kx):
                win = xp[:, :, yy:yy + oy * sy:sy, xx:xx + ox * sx:sx]
                win = win[:, :, :oy, :ox]
                out += np.einsum("nchw,oc->nohw", win, w[:, :, yy, xx],
                                 optimize=True)
        if b is not None:
            out += np.asarray(b, np.float64)[None, :, None, None]
        if relu:
            out = np.maximum(out, 0)
        if rfs.get_u32_or("out_q8", 0):
            # int8 storage edge: the epilogue stores the quantized value
            os_ = float(rfs.nda_vals["out_scale"].item())
            out = np.clip(np.round(out * (127.0 / os_)), -127, 127) \
                .astype(np.int8)
        return out


@template
class XlaConv(_ConvBase):
    """Vendor-library conv baseline (cuDNN role): stock XLA convolution."""

    name = "xla_conv"
    nhwc_ok = True

    @classmethod
    def build(cls, rfs: OpBase):
        import jax
        import jax.numpy as jnp

        from .util import storage_io
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        has_bias = "biases" in rfs.nda_vals
        bf16 = rfs.str_vals.get("prec") == "bf16"
        nhwc = rfs.str_vals.get("layout") == "nhwc"
        quant8 = rfs.get_u32_or("quant8", 0) == 1
        prequant = rfs.get_u32_or("prequant_w", 0) == 1
        act_absmax = float(rfs.nda_vals["act_scale"].item()) \
            if "act_scale" in rfs.nda_vals else 0.0
        # int8 storage edges (engine/lower._apply_int8_edges): in_q8 = the
        # input ARRIVES int8 at the static act_scale (skip the quantize);
        # out_q8 = quantize the output into the epilogue at out_scale
        in_q8 = rfs.get_u32_or("in_q8", 0) == 1
        out_q8 = rfs.get_u32_or("out_q8", 0) == 1
        # training-only sig (OpTune grad_q8): int8 weight-gradient conv
        # in the mxu_conv VJP; forward program is unchanged
        grad_q8 = rfs.get_u32_or("grad_q8", 0) == 1
        out_absmax = float(rfs.nda_vals["out_scale"].item()) \
            if "out_scale" in rfs.nda_vals else 0.0
        io_nhwc, edt = storage_io(rfs)
        out_dt = outd.dtype

        def _act_q(x):
            """activation int8 quant + its scale (static or dynamic).
            (named s_act, NOT sx: the stride sx is in scope)"""
            if in_q8:  # already quantized by the producer's epilogue
                return x, jnp.float32(act_absmax / 127.0)
            xf = x.astype(jnp.float32)
            s_act = jnp.float32(act_absmax / 127.0) if act_absmax else \
                jnp.max(jnp.abs(xf)) / 127.0 + 1e-30
            return (jnp.clip(jnp.round(xf / s_act), -127, 127)
                    .astype(jnp.int8), s_act)

        def _store(y, dt):
            """epilogue store: out_q8 edges store int8 at out_scale."""
            if out_q8:
                return jnp.clip(jnp.round(y.astype(jnp.float32)
                                          * (127.0 / out_absmax)),
                                -127, 127).astype(jnp.int8)
            return y.astype(dt)

        if io_nhwc:
            # storage-NHWC path: x arrives (img, y, x, chan) in edge dtype;
            # output stays NHWC in edge dtype — zero wrapping transposes
            store_dt = edt or out_dt
            cdt = jnp.bfloat16 if bf16 else jnp.float32

            if quant8 and prequant:
                # weights arrive PREQUANTIZED (int8 + per-oc scale): only
                # the activation quantizes in-program (lower.py pass)
                def fn_pq(x, wq, sws, b=None):
                    xq, s_act = _act_q(x)
                    y = jax.lax.conv_general_dilated(
                        xq, jnp.transpose(wq, (2, 3, 1, 0)),
                        window_strides=(sy, sx),
                        padding=((py, py), (px, px)),
                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                        preferred_element_type=jnp.int32)
                    y = y.astype(jnp.float32) * (s_act * sws)[None, None, None, :]
                    if has_bias and b is not None:
                        y = y + b.astype(y.dtype)[None, None, None, :]
                    if relu:
                        y = jnp.maximum(y, 0)
                    return _store(y, store_dt)
                return fn_pq

            def fn_st(x, w, b=None):
                wh = jnp.transpose(w, (2, 3, 1, 0))
                if quant8:
                    # int8 path: dynamic act quant + per-oc weight quant
                    xq, wq, sc = _quantize_conv_operands(x, wh, (0, 1, 2), act_absmax)
                    y = jax.lax.conv_general_dilated(
                        xq, wq, window_strides=(sy, sx),
                        padding=((py, py), (px, px)),
                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                        preferred_element_type=jnp.int32)
                    y = y.astype(jnp.float32) * sc
                else:
                    from ..mxu_grad import mxu_conv
                    y = mxu_conv(
                        x, wh, window_strides=(sy, sx),
                        padding=((py, py), (px, px)),
                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                        compute_dtype=cdt, wgrad_int8=grad_q8)
                if has_bias and b is not None:
                    y = y + b.astype(y.dtype)[None, None, None, :]
                if relu and not out_q8:
                    # output-residual epilogue: bit-identical forward,
                    # no f32 pre-activation residual under jax.grad
                    from ..mxu_grad import relu_store
                    return relu_store(y, store_dt)
                if relu:
                    y = jnp.maximum(y, 0)
                return _store(y, store_dt)
            return fn_st

        if quant8 and prequant:
            def fn_pq_nchw(x, wq, sws, b=None):
                xq, s_act = _act_q(x)
                y = jax.lax.conv_general_dilated(
                    xq, wq, window_strides=(sy, sx),
                    padding=((py, py), (px, px)),
                    dimension_numbers=("NCHW", "OIHW", "NCHW"),
                    preferred_element_type=jnp.int32)
                y = y.astype(jnp.float32) * (s_act * sws)[None, :, None, None]
                if has_bias and b is not None:
                    y = y + b.astype(y.dtype)[None, :, None, None]
                if relu:
                    y = jnp.maximum(y, 0)
                return y.astype(out_dt)
            return fn_pq_nchw

        def fn(x, w, b=None):
            if quant8:
                ax = (1, 2, 3)  # OIHW weights: per-out_chan over (I,ky,kx)
                xq, wq, sc = _quantize_conv_operands(x, w, ax, act_absmax)
                y = jax.lax.conv_general_dilated(
                    xq, wq, window_strides=(sy, sx),
                    padding=((py, py), (px, px)),
                    dimension_numbers=("NCHW", "OIHW", "NCHW"),
                    preferred_element_type=jnp.int32)
                y = y.astype(jnp.float32) * jnp.transpose(sc, (1, 0, 2, 3))
                if has_bias and b is not None:
                    y = y + b.astype(y.dtype)[None, :, None, None]
                if relu:
                    y = jnp.maximum(y, 0)
                return y.astype(out_dt)
            from ..mxu_grad import mxu_conv
            cdt = jnp.bfloat16 if bf16 else jnp.float32
            if nhwc:
                # channel-minor is cuDNN's tensor-core layout; the wrapping
                # transposes cancel pairwise inside the fused program
                xh = jnp.transpose(x, (0, 2, 3, 1))
                wh = jnp.transpose(w, (2, 3, 1, 0))
                y = mxu_conv(
                    xh, wh, window_strides=(sy, sx),
                    padding=((py, py), (px, px)),
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                    compute_dtype=cdt, wgrad_int8=grad_q8)
                if has_bias and b is not None:
                    y = y + b.astype(y.dtype)[None, None, None, :]
                if relu:
                    from ..mxu_grad import relu_store
                    return jnp.transpose(relu_store(y, out_dt),
                                         (0, 3, 1, 2))
                return jnp.transpose(y, (0, 3, 1, 2)).astype(out_dt)
            y = mxu_conv(
                x, w, window_strides=(sy, sx), padding=((py, py), (px, px)),
                dimension_numbers=("NCHW", "OIHW", "NCHW"),
                compute_dtype=cdt)
            if has_bias and b is not None:
                y = y + b.astype(y.dtype)[None, :, None, None]
            if relu:
                from ..mxu_grad import relu_store
                return relu_store(y, out_dt)
            return y.astype(out_dt)
        return fn


@template
class S2dConv(_ConvBase):
    """Space-to-depth first-layer conv: a stride-2 thin-channel conv
    (ResNet/VGG conv1: 7x7 s2 C=3) re-indexed as a stride-1 conv over
    2x2-phase-stacked input (C -> 4C, kernel k -> ceil(k/2)).

    Thin-channel convs underfill the matrix units (K = 3·k² after
    im2col); phase-stacking quadruples K and halves spatial extent — a
    standard first-layer transform. Exact same arithmetic as the
    original conv (weights re-indexed by tap parity, zero-padded to the
    per-phase kernel), pinned by an exactness test vs xla_conv.
    Reference role: a cnn_codegen conv variant selected by shape
    (cnn_op.cc:46-68 gating idiom); no CUDA analog."""

    name = "s2d_conv"
    nhwc_ok = True

    @classmethod
    def build(cls, rfs: OpBase):
        import jax
        import jax.numpy as jnp

        from .util import storage_io
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        assert sy == 2 and sx == 2, "s2d_conv requires stride 2"
        n, C, H, W = ind.shape
        oc, k_y, k_x = fd["out_chan"], fd["y"], fd["x"]
        oy, ox = outd["y"], outd["x"]
        ka, kb = -(-k_y // 2), -(-k_x // 2)
        has_bias = "biases" in rfs.nda_vals
        bf16 = rfs.str_vals.get("prec") == "bf16"
        io_nhwc, edt = storage_io(rfs)
        out_dt = edt or outd.dtype if io_nhwc else outd.dtype

        def fn(x, w, b=None):
            if bf16:
                x = x.astype(jnp.bfloat16)
                w = w.astype(jnp.bfloat16)
            if io_nhwc:
                # x arrives NHWC: phase-split on (y,x), stack on chan-minor
                xp = jnp.pad(x, ((0, 0), (py, py + 2), (px, px + 2), (0, 0)))
                phases = [xp[:, r::2, s::2, :][:, :oy + ka - 1, :ox + kb - 1, :]
                          for r in (0, 1) for s in (0, 1)]
                xh = jnp.concatenate(phases, axis=-1)     # (n, ..., 4C)
            else:
                # 2x2 phase-split of the padded input, phases stacked on chan
                xp = jnp.pad(x, ((0, 0), (0, 0), (py, py + 2), (px, px + 2)))
                phases = [xp[:, :, r::2, s::2][:, :, :oy + ka - 1, :ox + kb - 1]
                          for r in (0, 1) for s in (0, 1)]
                xs = jnp.concatenate(phases, axis=1)      # (n, 4C, ...)
                xh = jnp.transpose(xs, (0, 2, 3, 1))
            # weights re-indexed by tap parity, zero-padded to (ka, kb)
            wps = []
            for r in (0, 1):
                for s in (0, 1):
                    wp = w[:, :, r::2, s::2]
                    wps.append(jnp.pad(wp, ((0, 0), (0, 0),
                                            (0, ka - wp.shape[2]),
                                            (0, kb - wp.shape[3]))))
            ws = jnp.concatenate(wps, axis=1)             # (oc, 4C, ka, kb)
            wh = jnp.transpose(ws, (2, 3, 1, 0))
            # mxu_conv (not raw conv_general_dilated): the custom VJP
            # makes the s2d stem TRAINABLE — phase-stack/re-index are
            # plain differentiable jnp ops, and the grad convs of the
            # stacked form ARE the s2d training form.
            from ..mxu_grad import mxu_conv, relu_store
            y = mxu_conv(
                xh, wh, window_strides=(1, 1), padding=((0, 0), (0, 0)),
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
            if has_bias and b is not None:
                y = y + b.astype(y.dtype)[None, None, None, :]
            if relu:
                y = relu_store(y, out_dt)
            else:
                y = y.astype(out_dt)
            if io_nhwc:
                return y
            return jnp.transpose(y, (0, 3, 1, 2))
        return fn


@template
class K1Conv(_ConvBase):
    """1×1 conv as a matmul (reference: k1conv.cucl):
    (img·y·x, in_chan) @ (in_chan, out_chan), bias+ReLU fused after it."""

    name = "k1conv"
    nhwc_ok = True

    @classmethod
    def build(cls, rfs: OpBase):
        import jax.numpy as jnp

        from .util import storage_io
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        assert fd["y"] == 1 and fd["x"] == 1, "k1conv requires 1x1 kernel"
        n, C, H, W = ind.shape
        oc = fd["out_chan"]
        oy, ox = outd["y"], outd["x"]
        M, K, N = n * oy * ox, C, oc
        dt = "bfloat16" if rfs.str_vals.get("prec") == "bf16" else "float32"
        has_bias = "biases" in rfs.nda_vals
        io_nhwc, edt = storage_io(rfs)
        odt = str(edt and jnp.dtype(edt) or outd.dtype) if io_nhwc else str(outd.dtype)
        mm = matmul_epilogue(dt, odt, relu=relu, bias=has_bias)

        def fn(x, filts, b=None):
            if io_nhwc:
                if (sy, sx) != (1, 1):
                    x = x[:, ::sy, ::sx, :]
                a = x.reshape(M, K)
            else:
                if (sy, sx) != (1, 1):
                    x = x[:, :, ::sy, ::sx]
                a = jnp.transpose(x, (0, 2, 3, 1)).reshape(M, K)
            wmat = filts.reshape(oc, C).T  # (in_chan, out_chan)
            c = mm(a, wmat, b) if has_bias else mm(a, wmat)
            if io_nhwc:
                return c.reshape(n, oy, ox, oc)
            return jnp.transpose(c.reshape(n, oy, ox, oc), (0, 3, 1, 2))
        return fn


@template
class Conv(_ConvBase):
    """Direct conv as shifted-window matmul accumulation (reference:
    conv.cucl). For each (ky,kx) filter tap, a strided window of the padded
    NHWC input becomes an (img·oy·ox, in_chan) matrix multiplied against
    that tap's (in_chan, out_chan) filter slice; taps accumulate
    in f32. Stride-1 taps are pure slices (no im2col materialization)."""

    name = "conv"
    nhwc_ok = True

    @classmethod
    def build(cls, rfs: OpBase):
        import jax.numpy as jnp

        from .util import storage_io
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        n, C, H, W = ind.shape
        oc, ic, ky, kx = fd["out_chan"], fd["in_chan"], fd["y"], fd["x"]
        oy, ox = outd["y"], outd["x"]
        M, K, N = n * oy * ox, C * ky * kx, oc
        dt = "bfloat16" if rfs.str_vals.get("prec") == "bf16" else "float32"
        has_bias = "biases" in rfs.nda_vals
        io_nhwc, edt = storage_io(rfs)
        odt = str(edt and jnp.dtype(edt) or outd.dtype) if io_nhwc else str(outd.dtype)
        mm = matmul_epilogue(dt, odt, relu=relu, bias=has_bias)

        def fn(x, filts, b=None):
            if io_nhwc:
                xh = jnp.pad(x, ((0, 0), (py, py), (px, px), (0, 0)))
            else:
                xp = jnp.pad(x, ((0, 0), (0, 0), (py, py), (px, px)))
                xh = jnp.transpose(xp, (0, 2, 3, 1))  # NHWC
            cols = []
            for yy in range(ky):
                for xx in range(kx):
                    win = xh[:, yy:yy + (oy - 1) * sy + 1:sy,
                             xx:xx + (ox - 1) * sx + 1:sx, :]
                    cols.append(win.reshape(M, C))
            a = jnp.concatenate(cols, axis=1)  # (M, ky*kx*C)
            wmat = jnp.transpose(filts, (2, 3, 1, 0)).reshape(K, N)
            c = mm(a, wmat, b) if has_bias else mm(a, wmat)
            if io_nhwc:
                return c.reshape(n, oy, ox, oc)
            return jnp.transpose(c.reshape(n, oy, ox, oc), (0, 3, 1, 2))
        return fn


@template
class IpConv(_ConvBase):
    """InnerProduct / fully-connected as matmul (reference: ipconv.cucl):
    requires out spatial 1×1 and kernel covering the whole input."""

    name = "ipconv"
    nhwc_ok = True

    @classmethod
    def build(cls, rfs: OpBase):
        import jax.numpy as jnp

        from .util import storage_io
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        n, C, H, W = ind.shape
        oc = fd["out_chan"]
        assert outd["y"] == 1 and outd["x"] == 1, "ipconv requires 1x1 output"
        M, K, N = n, C * H * W, oc
        dt = "bfloat16" if rfs.str_vals.get("prec") == "bf16" else "float32"
        has_bias = "biases" in rfs.nda_vals
        io_nhwc, edt = storage_io(rfs)
        odt = str(edt and jnp.dtype(edt) or outd.dtype) if io_nhwc else str(outd.dtype)
        mm = matmul_epilogue(dt, odt, relu=relu, bias=has_bias)

        def fn(x, filts, b=None):
            a = x.reshape(M, K)
            if io_nhwc:
                # x is (img, y, x, chan): K order (y,x,chan) — reorder the
                # (oc, chan, y, x) filter to match
                wmat = jnp.transpose(filts.reshape(oc, C, H, W),
                                     (0, 2, 3, 1)).reshape(N, K).T
            else:
                wmat = filts.reshape(N, K).T
            c = mm(a, wmat, b) if has_bias else mm(a, wmat)
            if io_nhwc:
                return c.reshape(n, 1, 1, oc)
            return c.reshape(n, oc, 1, 1)
        return fn


@template
class Deconv(_ConvBase):
    """Transposed convolution (caffe Deconvolution; reference: accepted by
    the importer caffepb.cc:219 and shape-inferred both directions
    conv_util.cc:197,224, but never executed by rtc_fwd — it fell through
    to the caffe_fwd engine). Here it is a first-class template: the
    gradient-of-conv scatter, computed as an XLA convolution over the
    lhs-dilated input with a spatially-flipped kernel (lax lhs_dilation —
    no explicit zero-stuffed tensor materializes).

    Filts arrive in the pipe convention (out_chan, in_chan, y, x) where
    out_chan is this layer's OUTPUT channel count — the caffemodel's
    physical (in_chan, out_chan, ky, kx) blob is transposed at weight-copy
    time (graph/caffe_io.py). out spatial = (in-1)*stride + kernel - 2*pad
    (pipe.py conv_out_sz_to_in_sz)."""

    name = "deconv"
    nhwc_ok = True

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        ind = rfs.get_dims("in")
        fd = rfs.get_dims("filts")
        return 2 * ind.sz() * fd["out_chan"] * fd["y"] * fd["x"]

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, w, b=None):
        """Independent numpy scatter: each input pixel (iy,ix) adds
        x[n,i,iy,ix]·w[o,i,ky,kx] at out[n,o, iy·sy+ky−py, ix·sx+kx−px]."""
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        x = np.asarray(x, np.float64)
        w = np.asarray(w, np.float64)
        n, C, H, W = x.shape
        oc, ic, ky, kx = w.shape
        oy, ox = outd["y"], outd["x"]
        full = np.zeros((n, oc, (H - 1) * sy + ky, (W - 1) * sx + kx))
        for yy in range(ky):
            for xx in range(kx):
                full[:, :, yy:yy + (H - 1) * sy + 1:sy,
                     xx:xx + (W - 1) * sx + 1:sx] += \
                    np.einsum("nihw,oi->nohw", x, w[:, :, yy, xx],
                              optimize=True)
        out = full[:, :, py:py + oy, px:px + ox]
        if b is not None:
            out = out + np.asarray(b, np.float64)[None, :, None, None]
        if relu:
            out = np.maximum(out, 0)
        return out

    @classmethod
    def build(cls, rfs: OpBase):
        import jax
        import jax.numpy as jnp

        from .util import storage_io
        ind, outd, fd, sy, sx, py, px, relu = conv_params(rfs)
        ky, kx = fd["y"], fd["x"]
        has_bias = "biases" in rfs.nda_vals
        bf16 = rfs.str_vals.get("prec") == "bf16"
        io_nhwc, edt = storage_io(rfs)
        out_dt = outd.dtype
        store_dt = (edt or out_dt) if io_nhwc else out_dt
        cdt = jnp.bfloat16 if bf16 else jnp.float32
        # lhs-dilated "full" correlation with pad (k-1-p) and flipped taps
        # == the transposed-conv scatter; out = (in-1)*s + k - 2p
        pad = ((ky - 1 - py, ky - 1 - py), (kx - 1 - px, kx - 1 - px))

        def fn(x, w, b=None):
            from ..mxu_grad import mxu_conv
            wf = jnp.flip(w, axis=(2, 3))
            if io_nhwc:
                wh = jnp.transpose(wf, (2, 3, 1, 0))
                y = mxu_conv(
                    x, wh, window_strides=(1, 1), padding=pad,
                    lhs_dilation=(sy, sx),
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                    compute_dtype=cdt)
                if has_bias and b is not None:
                    y = y + b.astype(y.dtype)[None, None, None, :]
                if relu:
                    from ..mxu_grad import relu_store
                    return relu_store(y, store_dt)
                return y.astype(store_dt)
            y = mxu_conv(
                x, wf, window_strides=(1, 1),
                padding=pad, lhs_dilation=(sy, sx),
                dimension_numbers=("NCHW", "OIHW", "NCHW"),
                compute_dtype=cdt)
            if has_bias and b is not None:
                y = y + b.astype(y.dtype)[None, :, None, None]
            if relu:
                from ..mxu_grad import relu_store
                return relu_store(y, store_dt)
            return y.astype(store_dt)
        return fn


def make_deconv_op(n: int, cin: int, h: int, w: int, cout: int, ky: int,
                   kx: int, sy: int = 1, sx: int = 1, py: int = 0,
                   px: int = 0, relu: bool = False,
                   bias: bool = True) -> OpBase:
    """Helper: construct a Deconvolution op sig in the pipe convention."""
    oy = (h - 1) * sy + ky - 2 * py
    ox = (w - 1) * sx + kx - 2 * px
    op = OpBase({"type": "Deconvolution", "func_name": "deconv"})
    op.set_dims("in", Dims.make(img=n, chan=cin, y=h, x=w))
    op.set_dims("filts", Dims.make(out_chan=cout, in_chan=cin, y=ky, x=kx))
    if bias:
        op.set_dims("biases", Dims.make(out_chan=cout))
    op.set_dims("out", Dims.make(img=n, chan=cout, y=oy, x=ox))
    op.set_null_dims("in_pad", y=py, x=px)
    op.set_null_dims("stride", y=sy, x=sx)
    op.set_null_dims("kern_sz", y=ky, x=kx)
    if relu:
        op.set_u32("conv_has_relu", 1)
    return op


def make_conv_op(n: int, cin: int, h: int, w: int, cout: int, ky: int, kx: int,
                 sy: int = 1, sx: int = 1, py: int = 0, px: int = 0,
                 func_name: str = "xla_conv", relu: bool = False,
                 bias: bool = True) -> OpBase:
    """Helper: construct a Convolution op sig in reference layout."""
    oy = (h + 2 * py - ky) // sy + 1
    ox = (w + 2 * px - kx) // sx + 1
    op = OpBase({"type": "Convolution", "func_name": func_name})
    op.set_dims("in", Dims.make(img=n, chan=cin, y=h, x=w))
    op.set_dims("filts", Dims.make(out_chan=cout, in_chan=cin, y=ky, x=kx))
    if bias:
        op.set_dims("biases", Dims.make(out_chan=cout))
    op.set_dims("out", Dims.make(img=n, chan=cout, y=oy, x=ox))
    op.set_null_dims("in_pad", y=py, x=px)
    op.set_null_dims("stride", y=sy, x=sx)
    op.set_null_dims("kern_sz", y=ky, x=kx)
    if relu:
        op.set_u32("conv_has_relu", 1)
    return op
