"""Deconvolution (transposed conv) tests: the op the reference accepted in
its importer (caffepb.cc:219) and shape-inferred (conv_util.cc:197,224) but
never executed in rtc_fwd. Here it executes for real (deconv template,
lax lhs_dilation) — these tests pin:
  * template numerics vs the independent numpy scatter reference,
  * the k=1,s=1 shape-coincidence case (where the old xla_conv routing
    produced silently-wrong numbers: deconv contracts w over out_chan's
    transpose),
  * end-to-end engine agreement (ref float64 vs rtc) on a net with an
    upsampling deconv,
  * caffemodel weight-layout round-trip (caffe stores (in,out,ky,kx)).
"""

import numpy as np
import pytest

from boda_tpu.core.dims import NDA, Dims
from boda_tpu.engine.iface import make_engine
from boda_tpu.models.zoo import NetBuilder
from boda_tpu.ops.cnn_variants import add_cnn_codegen_annotations, make_op_tune
from boda_tpu.ops.pallas.conv import make_deconv_op
from boda_tpu.ops.pallas.gen_data import gen_test_nda
from boda_tpu.ops.registry import get_template

MRD_TOLER = 5e-4


def mrd(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = np.maximum(np.abs(a), np.abs(b)).max() + 1e-30
    return np.abs(a - b).max() / scale


def _run_deconv(n, cin, h, w, cout, k, stride, pad, relu=False, bias=True,
                io_layout=""):
    op = make_deconv_op(n, cin, h, w, cout, k, k, stride, stride, pad, pad,
                        relu=relu, bias=bias)
    if io_layout:
        op.str_vals["io_layout"] = io_layout
    tmpl = get_template("deconv")
    rfs = tmpl.check_args(op)
    fn = tmpl.build(rfs)
    rng = np.random.RandomState(7)
    x = rng.randn(n, cin, h, w).astype(np.float32) * 0.3
    wts = rng.randn(cout, cin, k, k).astype(np.float32) * 0.3
    args = [x, wts]
    if bias:
        args.append(rng.randn(cout).astype(np.float32))
    if io_layout == "nhwc":
        got = np.asarray(fn(np.transpose(x, (0, 2, 3, 1)), *args[1:]))
        got = np.transpose(got, (0, 3, 1, 2))
    else:
        got = np.asarray(fn(*args))
    want = np.asarray(tmpl.ref_impl(rfs, *args))
    return got, want


@pytest.mark.parametrize("case", [
    # FCN-style 2x upsampling: k=4 s=2 p=1
    dict(n=2, cin=8, h=6, w=6, cout=4, k=4, stride=2, pad=1),
    # k=3 s=1 p=1 (shape-preserving)
    dict(n=1, cin=8, h=7, w=5, cout=8, k=3, stride=1, pad=1, relu=True),
    # s=3 heavy upsample, no pad, no bias
    dict(n=1, cin=4, h=4, w=4, cout=8, k=5, stride=3, pad=0, bias=False),
])
def test_deconv_matches_ref(case):
    got, want = _run_deconv(**case)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_deconv_nhwc_storage_path():
    got, want = _run_deconv(n=1, cin=8, h=6, w=6, cout=4, k=4, stride=2,
                            pad=1, io_layout="nhwc")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_deconv_k1s1_weight_interpretation():
    """The VERDICT bug case: a 1x1 stride-1 deconv has the same output shape
    as a conv, so nothing crashes — but the caffemodel blob is physically
    (in_chan, out_chan, 1, 1) and the old plain-reshape weight copy
    interpreted it as (out_chan, in_chan, 1, 1): silently wrong numerics
    for any asymmetric W. Pin that the copy path transposes."""
    from boda_tpu.graph.caffe_io import copy_matching_layer_blobs_to_pipe
    b = NetBuilder("k1", 1, 4, 5, 5)
    b.deconv("d", 4, 1)
    pipe = b.done(init_weights=False)
    rng = np.random.RandomState(3)
    blob = rng.randn(4, 4, 1, 1).astype(np.float32)  # caffe (in, out, 1, 1)
    copy_matching_layer_blobs_to_pipe(
        pipe, {"d": [NDA(Dims.make(in_chan=4, out_chan=4, y=1, x=1), blob),
                     NDA(Dims.make(out_chan=4), np.zeros(4, np.float32))]})
    got_w = pipe.op_params["d_filts"].v
    # pipe convention (out, in, 1, 1) == transpose of the wire blob
    np.testing.assert_allclose(got_w, blob.transpose(1, 0, 2, 3))
    # and the old misinterpretation differs for this asymmetric blob
    assert mrd(got_w, blob.reshape(got_w.shape)) > 1e-2


def test_variant_gate_routes_deconv():
    op = make_deconv_op(1, 8, 6, 6, 4, 4, 4, 2, 2, 1, 1)
    op.str_vals.pop("func_name")
    for tune in ("()", "(use_culibs=1)", "(prec=bf16,layout=nhwc)"):
        add_cnn_codegen_annotations(op, make_op_tune(tune))
        assert op.func_name == "deconv"


def test_annotations_reset_between_tunes():
    """ADVICE r2 (medium): re-annotating one op graph with a different tune
    must not inherit stale layout/prec/quant8 from the previous tune."""
    from boda_tpu.ops.pallas.conv import make_conv_op
    op = make_conv_op(1, 32, 14, 14, 64, 3, 3, 1, 1, 1, 1)
    add_cnn_codegen_annotations(
        op, make_op_tune("(use_culibs=1,layout=nhwc,prec=bf16,quant8=1)"))
    assert op.str_vals.get("layout") == "nhwc"
    assert op.str_vals.get("prec") == "bf16"
    assert "quant8" in op.nda_vals
    add_cnn_codegen_annotations(op, make_op_tune("(use_culibs=1)"))
    assert "layout" not in op.str_vals
    assert "prec" not in op.str_vals
    assert "quant8" not in op.nda_vals


def _deconv_net(batch=1):
    """conv downsample -> 2x deconv upsample -> 1x1 deconv head."""
    b = NetBuilder("deconv-mini", batch, 3, 16, 16)
    b.conv("conv1", 8, 3, 2, 1)
    b.deconv("up1", 8, 4, 2, 1, relu=True)
    b.deconv("head", 4, 1)
    return b.done(seed=11)


def run_engine(spec, pipe, to_get):
    eng = make_engine(spec)
    eng.init(pipe)
    d = pipe.get_data_img_dims()
    return eng.run_fwd({"data": NDA(d, gen_test_nda(d, mode=0, scale=0.1))},
                       list(to_get))


def test_engines_agree_deconv_net():
    pipe = _deconv_net()
    assert pipe.must_get_node("up1").dims["y"] == 16  # (8-1)*2+4-2 = 16
    ref = run_engine("ref", pipe, ["head"])["head"].v
    fused = run_engine("(engine=rtc,fuse=1)", pipe, ["head"])["head"].v
    percall = run_engine("(engine=rtc,fuse=0)", pipe, ["head"])["head"].v
    assert ref.shape == fused.shape == (1, 4, 16, 16)
    assert mrd(ref, fused) < MRD_TOLER
    assert mrd(ref, percall) < MRD_TOLER


def test_engines_agree_deconv_net_storage_pass():
    pipe = _deconv_net()
    ref = run_engine("ref", pipe, ["head"])["head"].v
    st = run_engine("(engine=rtc,fuse=1,op_tune=(layout=nhwc,prec=bf16))",
                    pipe, ["head"])["head"].v
    assert mrd(ref, st) < 2e-2  # bf16 tolerance


def test_caffemodel_deconv_weight_layout_roundtrip(tmp_path):
    """Weights written/read through the caffemodel wire format use caffe's
    (in_chan, out_chan, ky, kx) physical deconv layout; the pipe keeps
    (out_chan, in_chan, y, x)."""
    from boda_tpu.graph.caffe_io import (copy_matching_layer_blobs_to_pipe,
                                         extract_layer_blobs,
                                         read_binary_net_param,
                                         write_caffemodel)
    pipe = _deconv_net()
    w_orig = pipe.op_params["up1_filts"].v.copy()
    assert w_orig.shape == (8, 8, 4, 4)
    # make it asymmetric so a transpose bug can't hide
    assert mrd(w_orig, np.transpose(w_orig, (1, 0, 2, 3))) > 1e-3
    p = tmp_path / "m.caffemodel"
    write_caffemodel(pipe, p)
    blobs = extract_layer_blobs(read_binary_net_param(p))
    # wire layout is caffe's (in, out, ky, kx)
    assert tuple(blobs["up1"][0].dims.shape) == (8, 8, 4, 4)
    np.testing.assert_allclose(
        blobs["up1"][0].v.reshape(8, 8, 4, 4),
        np.transpose(w_orig, (1, 0, 2, 3)), rtol=1e-6, atol=1e-7)
    # round-trip back into a fresh pipe
    pipe2 = _deconv_net()
    pipe2.op_params.clear()
    copy_matching_layer_blobs_to_pipe(pipe2, blobs)
    np.testing.assert_allclose(pipe2.op_params["up1_filts"].v, w_orig,
                               rtol=1e-6, atol=1e-7)
