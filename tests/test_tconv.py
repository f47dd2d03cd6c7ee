"""Convolution variant routing and the plain variants against the
independent numpy conv reference. Stride-1 convs with 128-multiple
in_chan, the reference's tconv.cucl territory (cnn_op.cc:158-192), go to
`xla_conv` (cuDNN's implicit-GEMM kernels); the rest take the im2col +
matmul `conv` path or `k1conv`."""

import numpy as np
import pytest

from boda_tpu.ops.pallas.conv import make_conv_op
from boda_tpu.ops.registry import get_template


def _run(func, n, cin, h, w, cout, k, pad, relu, bias, prec=""):
    op = make_conv_op(n, cin, h, w, cout, k, k, 1, 1, pad, pad,
                      func_name=func, relu=relu, bias=bias)
    if prec:
        op.str_vals["prec"] = prec
    tmpl = get_template(func)
    rfs = tmpl.check_args(op)
    fn = tmpl.build(rfs)
    rng = np.random.RandomState(0)
    x = rng.randn(n, cin, h, w).astype(np.float32) * 0.3
    wts = rng.randn(cout, cin, k, k).astype(np.float32) * 0.3
    args = [x, wts]
    if bias:
        args.append(rng.randn(cout).astype(np.float32))
    got = np.asarray(fn(*args))
    want = tmpl.ref_impl(rfs, *args)
    return got, np.asarray(want)


_CASES = [
    dict(n=1, cin=8, h=10, w=10, cout=16, k=3, pad=1, relu=False, bias=False),
    dict(n=2, cin=16, h=9, w=9, cout=32, k=3, pad=1, relu=True, bias=True),
    dict(n=1, cin=4, h=12, w=8, cout=8, k=5, pad=2, relu=False, bias=True),
    dict(n=1, cin=8, h=7, w=7, cout=8, k=1, pad=0, relu=True, bias=False),
]


@pytest.mark.parametrize("func", ["conv", "xla_conv"])
@pytest.mark.parametrize("case", _CASES)
def test_conv_variants_match_ref(func, case):
    got, want = _run(func, **case)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_k1conv_matches_ref():
    got, want = _run("k1conv", **_CASES[3])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_conv_bf16_close_to_ref():
    # bf16 operands, f32 accumulation: error bounded by bf16 rounding of
    # the inputs (2^-9 relative) summed over K = 9*16 taps
    got, want = _run("conv", n=1, cin=16, h=10, w=10, cout=16, k=3, pad=1,
                     relu=False, bias=True, prec="bf16")
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-2


def test_tconv_selected_by_variant_gate():
    """Stride-1 convs over 128-multiple in_chan route to xla_conv."""
    from boda_tpu.ops.cnn_variants import add_cnn_codegen_annotations, make_op_tune
    op = make_conv_op(1, 128, 14, 14, 32, 3, 3, 1, 1, 1, 1)
    add_cnn_codegen_annotations(op, make_op_tune("()"))
    assert op.func_name == "xla_conv"
    # strided conv takes the im2col path
    op2 = make_conv_op(1, 128, 14, 14, 32, 3, 3, 2, 2, 1, 1)
    add_cnn_codegen_annotations(op2, make_op_tune("()"))
    assert op2.func_name == "conv"
    # narrow stride-1 conv: im2col path too
    op3 = make_conv_op(1, 16, 14, 14, 32, 3, 3, 1, 1, 1, 1)
    add_cnn_codegen_annotations(op3, make_op_tune("()"))
    assert op3.func_name == "conv"
    # kernels wider than the im2col limit go to xla_conv
    op4 = make_conv_op(1, 16, 32, 32, 8, 13, 13, 2, 2, 0, 0)
    add_cnn_codegen_annotations(op4, make_op_tune("()"))
    assert op4.func_name == "xla_conv"
