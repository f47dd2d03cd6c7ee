"""xla_conv2 sibling-conv horizontal fusion (the ResNet projection pair
run as one wide conv; no reference analog)."""

import numpy as np
import pytest

from boda_tpu.core.dims import NDA
from boda_tpu.engine.iface import make_engine
from boda_tpu.engine.lower import lower_pipe
from boda_tpu.models.zoo import build_model
from boda_tpu.ops.cnn_variants import make_op_tune
from boda_tpu.ops.pallas.gen_data import gen_test_nda


def mrd(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.maximum(np.abs(a), np.abs(b)).max() + 1e-30)


def test_fuse_siblings_pass_pairs_projection_convs():
    pipe = build_model("resnet-50", batch=1, ysz=64, xsz=64)
    plan = lower_pipe(pipe, make_op_tune("(use_culibs=1,fuse_siblings=1,s2d=0)"))
    fused = [s for s in plan.steps if s.func_name == "xla_conv2"]
    # one pair per stage boundary: res2a, res3a, res4a, res5a
    assert len(fused) == 4, [s.call_tag for s in fused]
    tags = sorted(s.call_tag for s in fused)
    assert all("branch" in t and "+" in t for t in tags)
    # baseline plan unchanged without the knob
    plan2 = lower_pipe(pipe, make_op_tune("(use_culibs=1,s2d=0)"))
    assert not [s for s in plan2.steps if s.func_name == "xla_conv2"]


@pytest.mark.parametrize("tune", [
    "(use_culibs=1,fuse_siblings=1,s2d=0)",
    "(use_culibs=1,fuse_siblings=1,s2d=0,prec=bf16,layout=nhwc)",
])
def test_fuse_siblings_numerics(tune):
    pipe = build_model("resnet-50", batch=1, ysz=64, xsz=64)
    d = pipe.get_data_img_dims()
    blob = {"data": NDA(d, gen_test_nda(d, 0, 0.1))}
    base = make_engine("(engine=rtc,op_tune=(use_culibs=1,s2d=0))")
    base.init(pipe)
    want = base.run_fwd(blob, ["prob"])["prob"].v
    eng = make_engine(f"(engine=rtc,op_tune={tune})")
    eng.init(pipe)
    got = eng.run_fwd(blob, ["prob"])["prob"].v
    tol = 3e-2 if "bf16" in tune else 5e-4
    assert mrd(got, want) < tol


def test_fuse_siblings_inception_groups():
    """googlenet inception blocks: 3 same-input 1x1 branches fuse 3-way."""
    pipe = build_model("googlenet_conv", batch=1, ysz=64, xsz=64)
    plan = lower_pipe(pipe, make_op_tune("(use_culibs=1,fuse_siblings=1,s2d=0)"))
    fused = [s for s in plan.steps if s.func_name == "xla_conv2"]
    assert fused
    widths = [len([k for k in s.arg_nodes if k.startswith("filts_")])
              for s in fused]
    assert max(widths) >= 3  # inception 1x1 trios actually grouped
    d = pipe.get_data_img_dims()
    blob = {"data": NDA(d, gen_test_nda(d, 0, 0.1))}
    base = make_engine("(engine=rtc,op_tune=(use_culibs=1,s2d=0))")
    base.init(pipe)
    want = base.run_fwd(blob, ["prob"])["prob"].v
    eng = make_engine("(engine=rtc,op_tune=(use_culibs=1,fuse_siblings=1,s2d=0))")
    eng.init(pipe)
    got = eng.run_fwd(blob, ["prob"])["prob"].v
    assert mrd(got, want) < 5e-4


def test_fuse_siblings_ref_engine():
    """the float64 ref engine runs the fused plan through xla_conv2's
    independent numpy ref_impl — digests must match the rtc engine."""
    pipe = build_model("resnet-50", batch=1, ysz=64, xsz=64)
    d = pipe.get_data_img_dims()
    blob = {"data": NDA(d, gen_test_nda(d, 0, 0.1))}
    ref = make_engine("(engine=ref,op_tune=(use_culibs=1,fuse_siblings=1,s2d=0))")
    ref.init(pipe)
    want = ref.run_fwd(blob, ["prob"])["prob"].v
    eng = make_engine("(engine=rtc,op_tune=(use_culibs=1,fuse_siblings=1,s2d=0))")
    eng.init(pipe)
    got = eng.run_fwd(blob, ["prob"])["prob"].v
    assert mrd(got, want) < 5e-4


def test_fuse_siblings_mixed_kernel_fire_pairs():
    """squeezenet fire expand1x1 (pad0) + expand3x3 (pad1) share the
    squeeze output and satisfy the embed invariant (2p-k == -1): they
    fuse into one 3x3 conv with the 1x1 weights center-embedded —
    only under fuse_mixed_siblings (default off)."""
    pipe = build_model("squeezenet-1.0", batch=1, ysz=64, xsz=64)
    # default fuse_siblings: exact-kernel key -> fire expand pairs stay split
    p0 = lower_pipe(pipe, make_op_tune("(use_culibs=1,fuse_siblings=1,s2d=0)"))
    assert not [s for s in p0.steps
                if s.func_name == "xla_conv2" and "expand" in s.call_tag]
    plan = lower_pipe(pipe, make_op_tune(
        "(use_culibs=1,fuse_siblings=1,fuse_mixed_siblings=1,s2d=0)"))
    fused = [s for s in plan.steps if s.func_name == "xla_conv2"]
    exp = [s for s in fused if "expand" in s.call_tag]
    assert len(exp) == 8, [s.call_tag for s in fused]  # fire2..fire9
    for s in exp:
        ks = {s.sig.get_dims(k)["y"] for k in s.sig.nda_vals
              if k.startswith("filts_")}
        assert ks == {1, 3}  # genuinely mixed kernel sizes in one step
        kd = s.sig.get_dims("kern_sz")
        pd = s.sig.get_dims("in_pad")
        assert (kd["y"], kd["x"], pd["y"], pd["x"]) == (3, 3, 1, 1)
    d = pipe.get_data_img_dims()
    blob = {"data": NDA(d, gen_test_nda(d, 0, 0.1))}
    base = make_engine("(engine=rtc,op_tune=(use_culibs=1,s2d=0))")
    base.init(pipe)
    want = base.run_fwd(blob, ["prob"])["prob"].v
    eng = make_engine("(engine=rtc,op_tune=(use_culibs=1,fuse_siblings=1,"
                      "fuse_mixed_siblings=1,s2d=0))")
    eng.init(pipe)
    got = eng.run_fwd(blob, ["prob"])["prob"].v
    assert mrd(got, want) < 5e-4
    # the independent float64 ref engine agrees through its own path
    ref = make_engine("(engine=ref,op_tune=(use_culibs=1,fuse_siblings=1,"
                      "fuse_mixed_siblings=1,s2d=0))")
    ref.init(pipe)
    rv = ref.run_fwd(blob, ["prob"])["prob"].v
    assert mrd(got, rv) < 5e-4
