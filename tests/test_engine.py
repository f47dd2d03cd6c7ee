"""End-to-end engine tests: the test_compute_multi semantics at small scale —
run the same net through independent engines (rtc fused / rtc per-call /
ref float64) on the same deterministic inputs, compare outputs within
mrd_toler (reference default 5e-4, test_compute.cc:44-46).
"""

import numpy as np
import pytest

from boda_tpu.core.dims import NDA, Dims
from boda_tpu.engine.iface import make_engine
from boda_tpu.models.zoo import NetBuilder, build_model
from boda_tpu.ops.pallas.gen_data import gen_test_nda

MRD_TOLER = 5e-4


def mrd(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = np.maximum(np.abs(a), np.abs(b)).max() + 1e-30
    return np.abs(a - b).max() / scale


def small_nin(batch=1):
    """NiN-style all-conv net at 32x32 — exercises conv(+pad,+stride),
    1x1 conv (k1conv), pool (max+global-avg), dropout, softmax, concat."""
    b = NetBuilder("mini", batch, 3, 32, 32)
    b.conv("conv1", 16, 5, 2, 2)
    b.conv("cccp1", 16, 1)
    b.pool("pool1", 3, 2)
    b.conv("conv2a", 8, 3, 1, 1)
    c2a = b.cur
    b.cur = "pool1"
    b.conv("conv2b", 8, 1)
    c2b = b.cur
    b.concat("cat2", [c2a, c2b])
    b.pool("pool2", 2, 2, avg=True)
    b.dropout("drop")
    b.conv("fc-conv", 10, 1, relu=False)
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.softmax("prob")
    return b.done(seed=42)


def data_for(pipe, batch=1):
    d = pipe.get_data_img_dims()
    return {"data": NDA(d, gen_test_nda(d, mode=0, scale=0.1))}


def test_biasless_conv_fused_matches_ref():
    """A bias-less conv (bots=[in, filts], a form the importer/lowering
    support) must classify filts as a WEIGHT in the fused plan — the
    regression was weight_nodes requiring len(bots)>=3, which let the
    fused program zero-fill filts on first touch (silently wrong, while
    per-call mode worked)."""
    b = NetBuilder("biasless", 1, 3, 16, 16)
    b.conv("c1", 8, 3, 1, 1)
    b.conv("fc", 5, 1, relu=False)
    b.softmax("prob")
    pipe = b.done(seed=7)
    op = pipe.ops["c1"]
    op.bots = op.bots[:2]  # drop the bias bot
    pipe.bots.discard("c1_biases")
    pipe.nodes.pop("c1_biases", None)
    pipe.op_params.pop("c1_biases", None)
    ins = data_for(pipe)

    ref = make_engine("ref")
    ref.init(pipe)
    want = ref.run_fwd(ins, ["prob"])["prob"].v

    rtc = make_engine("(engine=rtc,fuse=1)")
    rtc.init(pipe)
    assert "c1_filts" in rtc.plan.weight_nodes
    got = rtc.run_fwd(ins, ["prob"])["prob"].v
    assert mrd(got, want) < MRD_TOLER
    assert float(np.abs(np.asarray(got)).sum()) > 0


def test_fetch_weight_node_fused_nhwc():
    """run_fwd(to_get=[<weight>]) under the NHWC storage pass must return
    the weight UNtransposed (the regression storage-out-transposed any
    fetched 4-d tensor) and without recompiling the net."""
    pipe = small_nin()
    eng = make_engine(
        "(engine=rtc,fuse=1,op_tune=(use_culibs=1,layout=nhwc))")
    eng.init(pipe)
    w = np.asarray(pipe.op_params["conv1_filts"].v)
    got = eng.run_fwd(data_for(pipe), ["conv1_filts", "prob"])
    np.testing.assert_allclose(np.asarray(got["conv1_filts"].v,
                                          np.float32), w, rtol=1e-6)


def test_fetch_fusion_eliminated_node_errors_fast():
    """Requesting a node that no step of the plan produces (what a fusion
    pass that swallows a block's interior leaves behind) raises a clear
    error WITHOUT paying a whole-net re-jit first."""
    import pytest

    from boda_tpu.core.error import RtErr
    pipe = build_model("resnet-50", batch=1, ysz=64, xsz=64)
    eng = make_engine("(engine=rtc,fuse=1,op_tune=(use_culibs=1))")
    eng.init(pipe)
    # stand-in for such a pass: drop the step writing res2b's interior
    eng.plan.steps = [s for s in eng.plan.steps
                      if "res2b_branch2a" not in s.arg_nodes.values()
                      or s.call_tag.startswith("res2b_branch2b")]
    with pytest.raises(RtErr, match="not produced by any step"):
        eng.run_fwd(data_for(pipe), ["res2b_branch2a", "prob"])


def test_quantize_spec_errors():
    """Quantize specs must fail loudly: a typo'd node name silently
    measuring nothing was the regression (the reference errored on
    unknown vars); a spec without name= is malformed."""
    import pytest

    from boda_tpu.core.error import RtErr
    pipe = small_nin()
    eng = make_engine(
        "(engine=rtc,fuse=1,quantize=(_=(name=no_such_node,max_val=2)))")
    with pytest.raises(RtErr, match="no step writes"):
        eng.init(pipe)
    eng2 = make_engine("(engine=rtc,fuse=1,quantize=(_=(max_val=2)))")
    with pytest.raises(RtErr, match="missing 'name'"):
        eng2.init(small_nin())


def run_engine(spec, pipe, to_get=("prob",)):
    eng = make_engine(spec)
    eng.init(pipe)
    return eng.run_fwd(data_for(pipe), list(to_get))


def test_engines_agree_small_nin():
    pipe = small_nin()
    ref = run_engine("ref", pipe)["prob"].v
    fused = run_engine("(engine=rtc,fuse=1)", pipe)["prob"].v
    percall = run_engine("(engine=rtc,fuse=0)", pipe)["prob"].v
    assert ref.shape == fused.shape == percall.shape == (1, 10, 1, 1)
    assert abs(ref.sum() - 1.0) < 1e-5  # softmax
    assert mrd(ref, fused) < MRD_TOLER, f"fused vs ref mrd={mrd(ref, fused)}"
    assert mrd(ref, percall) < MRD_TOLER
    assert mrd(fused, percall) < MRD_TOLER


def test_engines_agree_interp_backend():
    pipe = small_nin()
    ref = run_engine("ref", pipe)["prob"].v
    interp = run_engine("(engine=rtc,fuse=0,rtc=interp)", pipe)["prob"].v
    assert mrd(ref, interp) < MRD_TOLER


def test_variant_tunes_agree():
    """Different variant selections (vendor vs pallas) must agree numerically
    — the core ops-prof cross-check invariant."""
    pipe = small_nin()
    base = run_engine("(engine=rtc,op_tune=())", pipe)["prob"].v
    culibs = run_engine("(engine=rtc,op_tune=(use_culibs=1))", pipe)["prob"].v
    nok1 = run_engine("(engine=rtc,op_tune=(k1conv=0,ipconv=0))", pipe)["prob"].v
    assert mrd(base, culibs) < MRD_TOLER
    assert mrd(base, nok1) < MRD_TOLER


def test_intermediate_node_fetch():
    pipe = small_nin()
    outs = run_engine("(engine=rtc,fuse=1,keep_all_nodes=1)", pipe,
                      to_get=["conv1", "cat2", "prob"])
    assert outs["conv1"].dims.shape == (1, 16, 16, 16)
    assert outs["cat2"].dims.shape == (1, 16, 8, 8)  # pool ceil mode: 16→8
    # relu fused into conv1 must still produce post-relu values
    assert outs["conv1"].v.min() >= 0.0


def test_per_call_timing_report(tmp_path):
    pipe = small_nin()
    eng = make_engine(f"(engine=rtc,fuse=0,per_call_fn={tmp_path}/calls.txt)")
    eng.init(pipe)
    eng.run_fwd(data_for(pipe), ["prob"])
    txt = (tmp_path / "calls.txt").read_text()
    assert "conv1" in txt and "prob" in txt


def test_batch_gt_1():
    pipe = small_nin(batch=3)
    ref = run_engine("ref", pipe)["prob"].v
    fused = run_engine("(engine=rtc,fuse=1)", pipe)["prob"].v
    assert ref.shape == (3, 10, 1, 1)
    assert mrd(ref, fused) < MRD_TOLER


def test_stats_and_quantize():
    pipe = small_nin()
    eng = make_engine("(engine=rtc,fuse=1,enable_stats=1)")
    eng.init(pipe)
    eng.run_fwd(data_for(pipe), ["prob"])
    assert "conv1" in eng.stats
    smin, smax, savg, sssq = eng.stats["conv1"].v
    assert smin >= 0.0 and smax > 0  # post-relu
    # quantize hook changes outputs (coarse quantization)
    eq = make_engine("(engine=rtc,fuse=1,quantize=((name=conv1,max_val=1.0,keep_bits=2)))")
    eq.init(pipe)
    q = eq.run_fwd(data_for(pipe), ["prob"])["prob"].v
    base = run_engine("(engine=rtc,fuse=1)", pipe)["prob"].v
    assert not np.allclose(q, base)


def test_mesh_sharded_inference():
    """DP(+MP) sharded fused inference over the virtual 8-device CPU mesh
    matches single-device output (SURVEY §2.8 plan)."""
    pipe = small_nin(batch=8)
    single = run_engine("(engine=rtc,fuse=1)", pipe)["prob"].v
    dp = run_engine("(engine=rtc,fuse=1,mesh_dp=8)", pipe)["prob"].v
    assert mrd(single, dp) < 1e-5, f"dp mrd={mrd(single, dp)}"
    dpmp = run_engine("(engine=rtc,fuse=1,mesh_dp=4,mesh_mp=2)", pipe)["prob"].v
    assert mrd(single, dpmp) < 1e-5, f"dp+mp mrd={mrd(single, dpmp)}"


def test_determinism_hooks():
    """set_all_one_weights (conv_util.H:225) + force_zero_bias
    (rtc_fwd.cc:59): the reference's debug determinism hooks."""
    pipe = small_nin()
    pipe.set_all_one_weights()
    assert all(float(v.v.min()) == 1.0 and float(v.v.max()) == 1.0
               for v in pipe.op_params.values())
    import numpy as np
    ref = make_engine("ref")
    ref.init(pipe)
    with_bias = ref.run_fwd(data_for(pipe), ["conv1"])["conv1"].v
    for spec in ("(engine=rtc,fuse=1,force_zero_bias=1)",
                 "(engine=rtc,fuse=0,force_zero_bias=1)"):
        eng = make_engine(spec)
        eng.init(pipe)
        out = eng.run_fwd(data_for(pipe), ["conv1"])["conv1"].v
        # the pipe's biases are all-ones; the zero-bias engines must
        # differ from the with-bias reference by exactly 1.0 wherever
        # both are in the ReLU-linear region
        assert out.shape == with_bias.shape and np.isfinite(out).all()
        both_pos = (out > 0.5) & (with_bias > 0.5)
        assert both_pos.any()
        np.testing.assert_allclose((with_bias - out)[both_pos], 1.0,
                                   rtol=1e-4)


@pytest.mark.parametrize("fuse", [1, 0])
def test_nan_check_sanitizer(fuse):
    """nan_check=1 (SURVEY §5.2 sanitizer role): a non-finite weight must
    raise naming the FIRST node (step order) it poisons; clean nets run
    unchanged. Fused mode computes the flags device-side."""
    from boda_tpu.core.error import RtErr
    pipe = small_nin()
    ins = data_for(pipe)
    eng = make_engine(f"(engine=rtc,fuse={fuse},nan_check=1)")
    eng.init(pipe)
    eng.run_fwd(ins, ["prob"])  # clean net: no false positive

    pipe2 = small_nin()
    w = pipe2.op_params["conv2a_filts"]
    w.v = w.v.copy()
    w.v.reshape(-1)[3] = np.nan
    eng2 = make_engine(f"(engine=rtc,fuse={fuse},nan_check=1)")
    eng2.init(pipe2)
    with pytest.raises(RtErr, match="nan_check: non-finite.*conv2a"):
        eng2.run_fwd(data_for(pipe2), ["prob"])
    # without the sanitizer the same net runs to completion (NaNs flow)
    eng3 = make_engine(f"(engine=rtc,fuse={fuse})")
    eng3.init(pipe2)
    out = eng3.run_fwd(data_for(pipe2), ["prob"])["prob"].v
    assert np.isnan(np.asarray(out, np.float64)).any()


def test_per_call_mode_fused_siblings():
    """Per-call (fuse=0) execution of an xla_conv2 sibling step: the
    backend's run() must handle a template whose DECLARED outs (out_c/
    out_d) are absent from this instance's sig (present_args filtering —
    previously only the fused path exercised xla_conv2)."""
    from tests.test_storage import resnet_micro
    pipe = resnet_micro()
    ins = data_for(pipe, batch=2)
    ref = make_engine("ref")
    ref.init(pipe)
    want = ref.run_fwd(ins, ["prob"])["prob"].v

    pc = make_engine("(engine=rtc,fuse=0,op_tune=(use_culibs=1,"
                     "fuse_siblings=1))")
    pc.init(pipe)
    assert any(s.func_name == "xla_conv2" for s in pc.plan.steps), \
        "expected a fused sibling pair (r1_c1 + r1_proj share the stem)"
    got = pc.run_fwd(ins, ["prob"])["prob"].v
    assert mrd(got, want) < MRD_TOLER
    # and the int8+prequant form of the same step runs per-call too
    pq = make_engine("(engine=rtc,fuse=0,op_tune=(use_culibs=1,"
                     "fuse_siblings=1,quant8=1))")
    pq.init(pipe)
    assert any(s.sig.get_u32_or("prequant_w", 0) for s in pq.plan.steps)
    gq = pq.run_fwd(ins, ["prob"])["prob"].v
    assert (np.asarray(gq).reshape(2, -1).argmax(1)
            == np.asarray(want).reshape(2, -1).argmax(1)).all()


def test_interp_backend_runs_prequant_sigs():
    """be=interp executes prequant int8 sigs through _ConvBase.ref_impl's
    dequantize branch (the numpy known-good path must understand every
    sig shape the device path produces)."""
    from tests.test_storage import resnet_micro
    pipe = resnet_micro()
    ins = data_for(pipe, batch=2)
    ref = make_engine("ref")
    ref.init(pipe)
    want = ref.run_fwd(ins, ["prob"])["prob"].v
    ie = make_engine("(engine=rtc,fuse=0,rtc=(be=interp),"
                     "op_tune=(use_culibs=1,quant8=1))")
    ie.init(pipe)
    assert any(s.sig.get_u32_or("prequant_w", 0) for s in ie.plan.steps)
    got = ie.run_fwd(ins, ["prob"])["prob"].v
    assert mrd(got, want) < 0.05  # int8 quantization error band
    assert (np.asarray(got).reshape(2, -1).argmax(1)
            == np.asarray(want).reshape(2, -1).argmax(1)).all()


def test_fused_weights_committed_to_device():
    """Regression guard: the fused engine's weights must be committed jax
    Arrays, not numpy — jit re-uploads numpy args on EVERY call (~100MB
    per batch for resnet-50)."""
    import jax

    from tests.test_storage import resnet_micro
    eng = make_engine("rtc")
    eng.init(resnet_micro())
    assert eng._weights, "fused engine should hold resolved weights"
    for n, v in eng._weights.items():
        assert isinstance(v, jax.Array), \
            f"weight '{n}' is {type(v).__name__}, not a committed jax.Array"


def test_train_dropout_per_step_seeded_masks():
    """train_dropout lowering feeds a per-STEP dropout seed (engine/
    lower DROP_SEED_NODE): different seeds draw different masks (caffe's
    per-iteration redraw, dropout_layer.cpp — a trace-time-constant mask
    would be fixed pruning, zero regularization), the same seed is
    deterministic, the keep fraction tracks 1-ratio, and the jax mask
    exactly matches the numpy twin the ref engine uses."""
    import jax
    import numpy as np

    from boda_tpu.engine.lower import DROP_SEED_NODE, lower_pipe
    from boda_tpu.engine.rtc_fwd import build_fused_forward
    from boda_tpu.engine.lower import resolve_plan_weights
    from boda_tpu.models.zoo import build_model
    from boda_tpu.ops.pallas.elementwise import Dropout

    pipe = build_model("mini", batch=2)
    plan = lower_pipe(pipe, train_dropout=True)
    assert DROP_SEED_NODE in plan.input_nodes
    w = resolve_plan_weights(plan, pipe.op_params)
    fwd = jax.jit(build_fused_forward(plan))
    x = (np.random.RandomState(0).randn(
        *pipe.get_data_img_dims().shape) * 0.5).astype(np.float32)

    def run(seed):
        return np.asarray(fwd(
            {"data": x, DROP_SEED_NODE: np.asarray([seed], np.int32)},
            w)["prob"])

    p0, p0b, p1 = run(0), run(0), run(1)
    np.testing.assert_array_equal(p0, p0b)   # same seed: deterministic
    assert np.abs(p0 - p1).max() > 0         # fresh mask per step

    # mask statistics + numpy/jax twin exactness
    sh = (64, 1024)
    for seed in (0, 7, 123456):
        u_np = Dropout._mask32_np(seed, sh)
        import jax.numpy as jnp
        u_j = np.asarray(Dropout._mask32_jnp(jnp.int32(seed), sh))
        np.testing.assert_allclose(u_j, u_np.astype(np.float32),
                                   rtol=0, atol=0)
        keep = (u_np >= 0.4).mean()
        assert abs(keep - 0.6) < 0.01, keep
    # different seeds decorrelate
    assert (Dropout._mask32_np(1, sh) != Dropout._mask32_np(2, sh)).mean() \
        > 0.99
