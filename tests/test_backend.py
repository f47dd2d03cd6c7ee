"""Backend + codegen engine tests: var store, views, compile/run/timing,
signature dedup, cross-backend agreement (reference: rtc_test +
test_compute semantics at op granularity).
"""

import numpy as np
import pytest

from boda_tpu.backend.iface import RtcFuncCall, make_backend
from boda_tpu.core.dims import NDA, Dims
from boda_tpu.core.error import RtErr
from boda_tpu.ops.op_base import OpBase
from boda_tpu.ops.pallas.sgemm import make_sgemm_op
from boda_tpu.ops.registry import Codegen


@pytest.fixture(params=["xla", "interp"])
def be(request):
    b = make_backend(request.param)
    b.init()
    return b


def test_var_store(be):
    d = Dims.make(y=4, x=8)
    be.create_var_with_dims("v", d)
    assert be.get_var_dims("v") == d
    with pytest.raises(RtErr, match="duplicate var"):
        be.create_var_with_dims("v", d)
    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    be.copy_nda_to_var("v", NDA(d, x))
    out = be.copy_var_to_nda("v")
    np.testing.assert_array_equal(out.v, x)
    # reshaped view
    dv = Dims.make(n=32)
    be.create_var_with_dims_as_reshaped_view_of_var("vflat", dv, "v")
    flat = be.copy_var_to_nda("vflat")
    assert flat.dims == dv
    np.testing.assert_array_equal(flat.v, x.reshape(-1))
    be.release_var("vflat")
    be.release_var("v")
    with pytest.raises(RtErr, match="no var"):
        be.get_var_dims("v")


def test_dot_run_and_timing(be):
    cg = Codegen(be)
    d = Dims.make(n=256)
    for v in ("a", "b", "c"):
        be.create_var_with_dims(v, d)
    a = np.linspace(-1, 1, 256, dtype=np.float32)
    b = np.linspace(3, 4, 256, dtype=np.float32)
    be.copy_ndas_to_vars({"a": NDA(d, a), "b": NDA(d, b)})
    op = OpBase({"type": "dot", "func_name": "dot"})
    for v in ("a", "b", "c"):
        op.set_dims(v, d)
    cid = cg.gen_and_run(op, {"a": "a", "b": "b", "c": "c"})
    be.finish_and_sync()
    np.testing.assert_allclose(be.copy_var_to_nda("c").v, a * b, rtol=1e-6)
    assert be.get_dur(cid, cid) >= 0.0


def test_sig_dedup(be):
    cg = Codegen(be)
    op1 = make_sgemm_op(64, 64, 64)
    op2 = make_sgemm_op(64, 64, 64)
    op3 = make_sgemm_op(64, 64, 128)
    n1 = cg.gen_func(op1)
    n2 = cg.gen_func(op2)
    n3 = cg.gen_func(op3)
    assert n1 == n2  # same reduced sig → cached instance
    assert n3 != n1
    assert len(cg.compile_pend_list) == 2


def test_sgemm_both_backends():
    rng = np.random.RandomState(0)
    M, N, K = 64, 96, 32
    a = rng.randn(M, K).astype(np.float32)
    b = rng.randn(K, N).astype(np.float32)
    results = {}
    for bname, fname in (("xla", "sgemm"), ("interp", "sgemm")):
        be = make_backend(bname)
        be.init()
        cg = Codegen(be)
        op = make_sgemm_op(M, N, K, func_name=fname)
        be.create_var_with_dims("a", op.get_dims("a"))
        be.create_var_with_dims("b", op.get_dims("b"))
        be.create_var_with_dims("c", op.get_dims("c"))
        be.copy_ndas_to_vars({"a": NDA(op.get_dims("a"), a), "b": NDA(op.get_dims("b"), b)})
        cg.gen_and_run(op, {"a": "a", "b": "b", "c": "c"})
        results[(bname, fname)] = be.copy_var_to_nda("c").v
    want = a.astype(np.float64) @ b.astype(np.float64)
    for k, got in results.items():
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4, err_msg=str(k))


def test_sgemm_tuned_prec():
    """A tuned prec flows through the reduced sig → distinct instance."""
    be = make_backend("xla")
    be.init()
    cg = Codegen(be)
    op = make_sgemm_op(128, 128, 128)
    op2 = op.copy()
    op2.str_vals["prec"] = "bf16"
    assert cg.gen_func(op) != cg.gen_func(op2)


def test_plat_tag():
    assert make_backend("interp").get_plat_tag() == "interp:numpy"
    xb = make_backend("xla")
    assert xb.get_plat_tag().startswith("xla:")


def test_rtc_test_mode(capsys):
    from boda_tpu.core.has_main import create_and_run_has_main
    create_and_run_has_main("(mode=rtc_test,n=512)", global_vars={})
    assert "rtc_test PASSED" in capsys.readouterr().out
