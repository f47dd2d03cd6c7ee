"""Fused-storage pass tests: the whole-program NHWC/bf16-edge path
(engine/lower.py _apply_fused_storage) must match the plain NCHW/f32
lowering numerically.

Reference role: the rtc-vs-ref comp_util digest workflow (SURVEY §4) —
here specialized to the storage optimization: layout and edge
dtype are execution-time tune knobs, never semantic changes.
"""

import numpy as np
import pytest

from boda_tpu.core.dims import NDA
from boda_tpu.engine.iface import make_engine
from boda_tpu.engine.lower import (_apply_fused_storage, lower_pipe, resolve_plan_weights)
from boda_tpu.engine.rtc_fwd import build_fused_forward
from boda_tpu.models.zoo import NetBuilder, build_model
from boda_tpu.ops.cnn_variants import make_op_tune


def resnet_micro(batch=2):
    """Tiny residual net: stem conv+pool, one projection bottleneck, one
    identity bottleneck (eltwise SUM + in-place relu), global avgpool,
    fc-conv, softmax — the resnet-50 op mix at toy scale."""
    b = NetBuilder("resnet_micro", batch, 3, 32, 32)
    b.conv("conv1", 16, 5, 2, 2)
    b.pool("pool1", 3, 2)
    stem = b.cur
    b.conv("r1_c1", 8, 1)
    b.conv("r1_c2", 8, 3, 1, 1)
    b.conv("r1_c3", 32, 1, relu=False)
    br = b.cur
    b.cur = stem
    b.conv("r1_proj", 32, 1, relu=False)
    b.eltwise("r1_add", [br, b.cur])
    b.relu("r1_relu")
    x1 = b.cur
    b.conv("r2_c1", 8, 1)
    b.conv("r2_c2", 8, 3, 1, 1)
    b.conv("r2_c3", 32, 1, relu=False)
    b.eltwise("r2_add", [b.cur, x1])
    b.relu("r2_relu")
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.conv("fc", 10, 1, relu=False)
    b.softmax("prob")
    return b.done(seed=7)


def incep_micro(batch=2):
    """Concat/LRN/dropout op mix (googlenet/alexnet shapes at toy scale):
    exercises the Copy INOUT first-touch, chan-window LRN, and dropout
    under NHWC storage."""
    b = NetBuilder("incep_micro", batch, 3, 32, 32)
    b.conv("conv1", 16, 3, 2, 1)
    b.lrn("lrn1")
    stem = b.cur
    b.conv("i1_a", 8, 1)
    ba = b.cur
    b.cur = stem
    b.conv("i1_b", 8, 3, 1, 1)
    b.concat("i1_cat", [ba, b.cur])
    b.pool("pool1", 3, 2)
    b.dropout("drop1")
    b.conv("fc", 10, 1, relu=False)
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.softmax("prob")
    return b.done(seed=11)


def _run(pipe, tune_s, fused_storage, x):
    plan = lower_pipe(pipe, make_op_tune(tune_s), fused_storage=fused_storage)
    fwd = build_fused_forward(plan)
    weights = resolve_plan_weights(plan, pipe.op_params)
    outs = fwd({"data": x}, weights)
    return plan, {k: np.asarray(v) for k, v in outs.items()}


@pytest.mark.parametrize("model", ["mini", "micro-res", "micro-incep"])
def test_storage_nhwc_f32_matches_plain(model):
    pipe = {"mini": lambda: build_model("mini", batch=2),
            "micro-res": resnet_micro,
            "micro-incep": incep_micro}[model]()
    d = pipe.get_data_img_dims()
    x = (np.random.RandomState(0).randn(*d.shape) * 0.2).astype(np.float32)
    plan_p, ref = _run(pipe, "(use_culibs=1)", False, x)
    plan_s, got = _run(pipe, "(use_culibs=1,layout=nhwc)", True, x)
    assert not plan_p.storage_nhwc
    assert plan_s.storage_nhwc and plan_s.edge_prec == ""
    assert all(s.sig.str_vals.get("io_layout") == "nhwc" for s in plan_s.steps)
    for k in ref:
        # same math, different reduction order (NHWC conv) -> tight tol
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, atol=2e-6)


def test_storage_nhwc_bf16_edges_close():
    pipe = resnet_micro()
    d = pipe.get_data_img_dims()
    x = (np.random.RandomState(1).randn(*d.shape) * 0.2).astype(np.float32)
    _, ref = _run(pipe, "(use_culibs=1)", False, x)
    plan_s, got = _run(pipe, "(use_culibs=1,prec=bf16,layout=nhwc)", True, x)
    assert plan_s.storage_nhwc and plan_s.edge_prec == "bf16"
    for k in ref:
        # bf16 compute + bf16 edges: ~2 decimal digits
        mrd = np.abs(got[k] - ref[k]).max() / (np.abs(ref[k]).max() + 1e-9)
        assert mrd < 0.05, (k, mrd)


def test_storage_edge_prec_f32_override():
    pipe = resnet_micro()
    plan = lower_pipe(pipe, make_op_tune(
        "(use_culibs=1,prec=bf16,layout=nhwc,edge_prec=f32)"),
        fused_storage=True)
    assert plan.storage_nhwc and plan.edge_prec == ""


def test_storage_pass_disables_on_unsupported_template():
    """A plan containing any template without nhwc_ok keeps wrapper mode."""
    pipe = build_model("mini", batch=1)
    plan = lower_pipe(pipe, make_op_tune("(use_culibs=1,layout=nhwc)"),
                      fused_storage=True)
    assert plan.storage_nhwc
    plan2 = lower_pipe(pipe, make_op_tune("(use_culibs=1,layout=nhwc)"),
                       fused_storage=False)
    plan2.steps[0].sig.set_func_name("sgemm")  # sgemm: nhwc_ok=False
    _apply_fused_storage(plan2, make_op_tune("(use_culibs=1,layout=nhwc)"))
    assert not plan2.storage_nhwc


def test_storage_engine_digest_path():
    """RtcFwd fused engine with storage active returns logical NCHW f32
    NDAs for every requested node (digest fetch path), and matches the
    plain engine within bf16 tolerance."""
    pipe = resnet_micro()
    d = pipe.get_data_img_dims()
    x = NDA(d, (np.random.RandomState(2).randn(*d.shape) * 0.2).astype(np.float32))

    eng = make_engine("(engine=rtc,op_tune=(use_culibs=1,prec=bf16,layout=nhwc))")
    eng.init(pipe)
    assert eng.plan.storage_nhwc
    inner = [n for n in eng.plan.node_dims
             if eng.plan.node_dims[n].names() == ("img", "chan", "y", "x")][:3]
    want = sorted(pipe.tops) + inner
    outs = eng.run_fwd({"data": x}, want)
    for n in want:
        nd = eng.plan.node_dims[n]
        assert tuple(outs[n].v.shape) == tuple(nd.shape), n
        assert outs[n].v.dtype == nd.dtype, n

    ref_eng = make_engine("(engine=rtc,op_tune=(use_culibs=1))")
    ref_eng.init(pipe)
    ref_outs = ref_eng.run_fwd({"data": x}, want)
    for n in want:
        a, b = outs[n].v, ref_outs[n].v
        mrd = np.abs(a - b).max() / (np.abs(b).max() + 1e-9)
        assert mrd < 0.05, (n, mrd)
