"""Differentiable mixed-precision convolution.

The inference templates issue bf16 x bf16 -> f32 convs
(`preferred_element_type=f32`: bf16 multiply, f32 accumulate).
JAX cannot transpose that primitive — the backward conv would pair an
f32 cotangent with bf16 operands — so `jax.grad` through the fused
forward fails, and falling back to f32 operands runs at the
HIGHEST-precision f32 rate (ops/precision.dot_precision forces that
deliberately for f32 numerics parity).

`mxu_conv` keeps the EXACT inference primal (bit-identical HLO when not
differentiated) and attaches a custom VJP whose gradient convolutions
are themselves bf16 convs. The tensor cores accumulate in f32 regardless
of the output element type, so the bf16-output grad convs lose only one
final rounding — the standard mixed-precision training recipe (f32
master weights, bf16 compute).

Reference role: the reference framework trained via hand-written
backward CUCL kernels (BckConv/Spreading, cnn_codegen.cc:480+); here
the training path differentiates the lowered program and this module
supplies the mixed-precision derivative rules.

Scope: wired into the conv call sites of xla_conv / xla_conv2 / deconv
(everything the default `use_culibs=1` training config lowers to). The
variant templates (ipconv/k1conv/conv matmuls, sgemm) remain
inference-only — training with a tune that selects them raises at
transpose time rather than silently running slow.
"""

from __future__ import annotations


def relu_store(y, dt):
    """Fused relu+storage-convert epilogue with an OUTPUT-residual VJP.

    Forward: maximum(y.astype(dt), 0) — bit-identical to the plain
    maximum(y, 0).astype(dt) epilogue (round-to-nearest preserves sign,
    and maximum(-0, 0) = +0), so inference programs and golden digests
    are unchanged.

    The point is the backward residual. jnp.maximum's VJP saves its
    INPUT — the f32 pre-activation — so every conv+relu in a training
    graph stores a full f32 activation tensor alongside the bf16 edge
    (measured: the f32[img,y,x,chan] residual stores/re-reads were the
    dominant non-matmul traffic in the resnet-50 b128 training step,
    cnet_xprof --bwd, ROUND4_NOTES r4). Here the residual is the OUTPUT
    tensor itself: the same buffer the consumer op reads, so XLA
    aliases them and the epilogue adds ZERO residual traffic. The mask
    out > 0 differs from y > 0 only where a positive y rounds to +0 in
    `dt` (subgradient at the kink — any choice is valid).
    """
    global _relu_out
    import jax.numpy as jnp
    if _relu_out is None:
        _relu_out = _make_relu_out()
    return _relu_out(y.astype(jnp.dtype(dt)))


def _make_relu_out():
    import jax
    import jax.numpy as jnp

    @jax.custom_vjp
    def _relu_out(y):
        return jnp.maximum(y, 0)

    def _fwd(y):
        out = jnp.maximum(y, 0)
        return out, out

    def _bwd(out, g):
        return (jnp.where(out > 0, g, 0),)

    _relu_out.defvjp(_fwd, _bwd)
    return _relu_out


_relu_out = None  # built lazily on first relu_store call (defers jax)


def mxu_conv(x, w, *, window_strides, padding, dimension_numbers,
             feature_group_count: int = 1, lhs_dilation=None,
             rhs_dilation=None, compute_dtype=None,
             wgrad_int8: bool = False):
    """conv_general_dilated with `compute_dtype` operands, f32 output
    accumulation, and a mixed-precision custom VJP.

    Primal: conv(x.astype(cd), w.astype(cd), preferred_element_type=f32)
    — identical to the raw template call. Backward: jax's own transpose
    of the uniform-dtype conv (all operands `cd`), so the grad convs run
    bf16 with in-hardware f32 accumulation. Returned
    cotangents match the (cast) operand dtypes; the enclosing
    `astype(cd)` casts round-trip them to the caller's dtypes (f32
    master weights stay f32).

    wgrad_int8 (OpTune grad_q8): compute the WEIGHT-gradient contraction
    in int8 — dynamic per-tensor quantization of the saved
    activation, per-out-channel quantization of the cotangent, int8x
    int8->int32 conv, f32 rescale (the training-side analog of the
    quant8 forward path; the reference profiled its BckConv generators
    like any op, cnn_codegen.cc:480+ / rtc_prof.cc:44). The input
    gradient (dgrad) stays bf16 — it feeds the whole downstream chain,
    while dW meets an lr-scaled optimizer update. Honored only for the
    plain NHWC no-dilation single-group conv (the trainable xla_conv /
    xla_conv2 storage path); other forms silently keep the bf16 VJP."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from .precision import dot_precision

    cd = jnp.dtype(compute_dtype or jnp.bfloat16)
    kw = dict(window_strides=tuple(window_strides),
              padding=tuple(tuple(p) for p in padding),
              dimension_numbers=dimension_numbers,
              feature_group_count=feature_group_count)
    if lhs_dilation is not None:
        kw["lhs_dilation"] = tuple(lhs_dilation)
    if rhs_dilation is not None:
        kw["rhs_dilation"] = tuple(rhs_dilation)
    prec = dot_precision(cd)
    wgrad_int8 = bool(
        wgrad_int8
        and dimension_numbers == ("NHWC", "HWIO", "NHWC")
        and feature_group_count == 1
        and (lhs_dilation is None or tuple(lhs_dilation) == (1, 1))
        and (rhs_dilation is None or tuple(rhs_dilation) == (1, 1))
        and all(not isinstance(p, str) and len(tuple(p)) == 2
                for p in padding))  # numeric (lo,hi) pairs only

    @jax.custom_vjp
    def _conv(xc, wc):
        return lax.conv_general_dilated(
            xc, wc, preferred_element_type=jnp.float32, precision=prec,
            **kw)

    def _fwd(xc, wc):
        return _conv(xc, wc), (xc, wc)

    def _bwd(res, g):
        xc, wc = res
        # int32-overflow guard (static: shapes are known at trace time):
        # the dW contraction sums N*OH*OW int8xint8 products; beyond
        # 2^31/127^2 ~ 133k terms a worst-case sum wraps the int32
        # accumulator SILENTLY, so such shapes keep the bf16 VJP (the
        # shipped grad_q8 preset sites are 28^2/14^2/7^2 at b128 —
        # <= 100k terms — all within bound)
        q8_ok = wgrad_int8 and (
            g.shape[0] * g.shape[1] * g.shape[2] * 127 * 127 < 2 ** 31)
        # uniform-dtype conv: transposable by jax; its grad convs are
        # bf16 (f32 hardware accumulate, one final rounding)
        if not q8_ok:
            _, vjp = jax.vjp(
                lambda a, b: lax.conv_general_dilated(a, b, precision=prec,
                                                      **kw), xc, wc)
            return vjp(g.astype(cd))
        # dgrad: bf16 via jax's transpose w.r.t. the input only
        _, vjp_x = jax.vjp(
            lambda a: lax.conv_general_dilated(a, wc, precision=prec,
                                               **kw), xc)
        dx, = vjp_x(g.astype(cd))
        return dx, _wgrad_q8(xc, wc, g, tuple(window_strides),
                             kw["padding"]).astype(cd)

    _conv.defvjp(_fwd, _bwd)
    return _conv(x.astype(cd), w.astype(cd))


def _wgrad_q8(xc, wc, g, window_strides, padding):
    """int8 weight-gradient conv (NHWC / HWIO / NHWC forward only).

    dW[ky,kx,I,O] = Σ_{n,oy,ox} x[n, oy·s+ky−p, ox·s+kx−p, I] · g[n,oy,ox,O]
    — a conv with x as lhs (batch axis acting as the contracted feature),
    the cotangent as the kernel (dilated by the forward stride), and the
    kernel taps as the output spatial extent: dimension_numbers
    ("CHWN","IHWO","HWNC"), window_strides = fwd rhs_dilation = 1,
    rhs_dilation = fwd stride, pad_lo = fwd pad_lo, pad_hi chosen so the
    output spatial extent is exactly (ky,kx) (jax's own transpose-rhs
    padding rule). Quantization: per-tensor dynamic scale for the saved
    activation, per-out-channel scale for the cotangent (each dW column
    O rescales independently — gradients' dynamic range lives across
    output channels); int8×int8→int32, one f32 rescale."""
    import jax.numpy as jnp
    from jax import lax

    xf = xc.astype(jnp.float32)
    s_x = jnp.max(jnp.abs(xf)) / 127.0 + 1e-30
    xq = jnp.clip(jnp.round(xf / s_x), -127, 127).astype(jnp.int8)
    gf = g.astype(jnp.float32)
    s_g = jnp.max(jnp.abs(gf), axis=(0, 1, 2), keepdims=True) / 127.0 \
        + 1e-30
    gq = jnp.clip(jnp.round(gf / s_g), -127, 127).astype(jnp.int8)
    pads = []
    for d in range(2):
        in_d, k_d, o_d = xc.shape[1 + d], wc.shape[d], g.shape[1 + d]
        lo = padding[d][0]
        pads.append((lo, (o_d - 1) * window_strides[d] + 1 - in_d
                     + k_d - lo - 1))
    dwq = lax.conv_general_dilated(
        xq, gq, window_strides=(1, 1), padding=pads,
        rhs_dilation=window_strides,
        dimension_numbers=("CHWN", "IHWO", "HWNC"),
        preferred_element_type=jnp.int32)
    return dwq.astype(jnp.float32) * (s_x * s_g.reshape(1, 1, 1, -1))
