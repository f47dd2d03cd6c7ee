"""Tuning-stack tests: wisdom IO/merge, profile_rcg_call, ops_prof sweep
with cross-checking, cnn_op_info (minimum-slice checkpoint A from
SURVEY.md §7: sgemm op-sig file runs and cross-checks vs the vendor path).
"""

import io
from pathlib import Path

import numpy as np
import pytest

from boda_tpu.backend.iface import make_backend
from boda_tpu.core.error import RtErr
from boda_tpu.core.has_main import create_and_run_has_main
from boda_tpu.ops.op_base import OpBase, read_op_sigs
from boda_tpu.ops.registry import Codegen
from boda_tpu.tune.prof import profile_rcg_call
from boda_tpu.tune.wisdom import (OpWisdom, merge_wisdoms, read_wisdom_stream,
                                  write_op_wisdom)

OPS_DIR = Path(__file__).parent / "data" / "ops"


def test_wisdom_round_trip_and_merge():
    op = OpBase.from_lexp("(type=sgemm,dims_vals=(a=(M=64,K=64),b=(K=64,N=64),c=(M=64,N=64)))")
    w = OpWisdom(op)
    w.tune("(Mb=256)").add_run("xla:gpu:h100", 1.5e-3)
    w.tune("(Mb=256)").add_run("interp:numpy", 2.0)
    w.tune("(use_culibs=1)").add_run("xla:gpu:h100", 1.0e-3)
    from boda_tpu.core.digest import nda_digest
    w.kgs["c"] = nda_digest(np.ones((4, 4), np.float32))
    buf = io.StringIO()
    write_op_wisdom(w, buf)
    ws2 = list(read_wisdom_stream(io.StringIO(buf.getvalue())))
    assert len(ws2) == 1
    w2 = ws2[0]
    assert w2.op == op
    assert w2.tunes["(Mb=256)"].runs["xla:gpu:h100"] == pytest.approx(1.5e-3)
    assert w2.best_tune("xla:gpu:h100") == ("(use_culibs=1)", pytest.approx(1.0e-3))
    assert "c" in w2.kgs
    # merge: keeps min secs per (tune, plat)
    w3 = OpWisdom(op)
    w3.tune("(Mb=256)").add_run("xla:gpu:h100", 1.2e-3)
    merged = merge_wisdoms([[w2], [w3]])
    assert len(merged) == 1
    assert merged[0].tunes["(Mb=256)"].runs["xla:gpu:h100"] == pytest.approx(1.2e-3)


def test_sgemm_baseline_wisdom_artifact_loads():
    """The on-chip SGEMM baseline sweep artifact (BASELINE config #1 table,
    docs/PERF.md) must stay readable: 6 ops (128³..4096³), each with the
    vendor kg + bf16 + pallas tunes recorded for the TPU plat tag."""
    data = Path(__file__).parent / "data"
    with open(data / "wisdom-sgemm-baseline.wis") as f:
        ws = list(read_wisdom_stream(f))
    assert len(ws) == 6
    for w in ws:
        # tunes are keyed by tune string: vendor f32 kg, vendor bf16, pallas
        assert {"(use_culibs=1)", "(use_culibs=1,prec=bf16)",
                "(prec=bf16)"} <= set(w.tunes)
        plats = {p for t in w.tunes.values() for p in t.runs}
        assert any(p.startswith("xla:tpu") for p in plats)
        assert all(s > 0 for t in w.tunes.values() for s in t.runs.values())
        assert "c" in w.kgs  # cross-check digests recorded


def test_sgemm_int8_wisdom_artifact_loads():
    """The on-chip int8 SGEMM sweep artifact (docs/PERF.md int8
    extension): 6 ops with the (prec=int8) tune recorded for TPU."""
    data = Path(__file__).parent / "data"
    with open(data / "wisdom-sgemm-int8.wis") as f:
        ws = list(read_wisdom_stream(f))
    assert len(ws) == 6
    for w in ws:
        assert "(prec=int8)" in w.tunes
        assert any(p.startswith("xla:tpu")
                   for p in w.tunes["(prec=int8)"].runs)


def test_conv_baseline_wisdom_artifact_loads():
    """The on-chip conv baseline sweep artifact (BASELINE conv row —
    3x3 384ch 13x13 b5, docs/PERF.md) must stay readable: one op with
    vendor f32 kg + vendor bf16 + hand tconv tunes for the TPU plat tag."""
    data = Path(__file__).parent / "data"
    with open(data / "wisdom-conv-baseline.wis") as f:
        ws = list(read_wisdom_stream(f))
    assert len(ws) == 1
    w = ws[0]
    assert w.op.type == "Convolution"
    assert w.op.get_dims("filts")["in_chan"] == 384
    assert {"(use_culibs=1)", "(use_culibs=1,prec=bf16)",
            "(prec=bf16)", "(tconv=0,prec=bf16)"} <= set(w.tunes)
    plats = {p for t in w.tunes.values() for p in t.runs}
    assert any(p.startswith("xla:tpu") for p in plats)
    assert all(s > 0 for t in w.tunes.values() for s in t.runs.values())
    assert "out" in w.kgs


def test_profile_rcg_call():
    be = make_backend("xla")
    be.init()
    cg = Codegen(be)
    ops = read_op_sigs(OPS_DIR / "sgemm-tiny.txt")
    secs, outs = profile_rcg_call(cg, _ann(ops[0]), run_iter=2)
    assert secs >= 0
    assert outs["c"].dims.shape == (128, 128)
    assert float(np.abs(outs["c"].v).sum()) > 0  # gen_data actually fed inputs


def _ann(op):
    from boda_tpu.ops.cnn_variants import add_codegen_annotations, make_op_tune
    op = op.copy()
    add_codegen_annotations(op, make_op_tune(None))
    return op


def test_ops_prof_mode(tmp_path, capsys):
    create_and_run_has_main(
        f"(mode=ops_prof,ops_fn={OPS_DIR}/sgemm-tiny.txt,"
        f"rtcs=(xla=(be=xla)),"
        f"op_tunes=(kg=(use_culibs=1),pallas=(),big=(ipconv=0)),"
        f"run_iter=2,boda_output_dir={tmp_path},wisdom_out_fn=out.wis)",
        global_vars={})
    out = capsys.readouterr().out
    assert "COMP_FAIL" not in out
    assert "tune=pallas" in out and "tune=kg" in out
    wis = (tmp_path / "out.wis").read_text()
    assert wis.count("op_wisdom_t") == 2
    assert "op_kg_t c" in wis
    # cross-check failure detection: rerun against corrupted kg digests
    bad = wis.replace("cnt=16384", "cnt=99")
    (tmp_path / "bad.wis").write_text(bad)
    with pytest.raises(RtErr, match="errors"):
        create_and_run_has_main(
            f"(mode=ops_prof,ops_fn={OPS_DIR}/sgemm-tiny.txt,"
            f"rtcs=(xla=(be=xla)),run_iter=1,"
            f"wisdom_in_fn={tmp_path}/bad.wis)",
            global_vars={})


def test_ops_prof_conv(tmp_path, capsys):
    create_and_run_has_main(
        f"(mode=ops_prof,ops_fn={OPS_DIR}/conv-tiny.txt,"
        f"rtcs=(xla=(be=xla)),"
        f"op_tunes=(kg=(use_culibs=1),pall=()),run_iter=1)",
        global_vars={})
    out = capsys.readouterr().out
    assert "COMP_FAIL" not in out and "ERROR" not in out
    assert "func=conv" in out or "func=k1conv" in out


def test_wis_merge_ana_modes(tmp_path, capsys):
    create_and_run_has_main(
        f"(mode=ops_prof,ops_fn={OPS_DIR}/sgemm-tiny.txt,rtcs=(xla=(be=xla)),"
        f"op_tunes=(kg=(use_culibs=1),p=()),run_iter=1,"
        f"boda_output_dir={tmp_path},wisdom_out_fn=a.wis)", global_vars={})
    create_and_run_has_main(
        f"(mode=wis_merge,wisdom_in_fns=({tmp_path}/a.wis,{tmp_path}/a.wis),"
        f"boda_output_dir={tmp_path},wisdom_out_fn=m.wis)", global_vars={})
    capsys.readouterr()
    create_and_run_has_main(
        f"(mode=wis_ana,wisdom_in_fn={tmp_path}/m.wis,csv_fn=w.csv,"
        f"boda_output_dir={tmp_path})", global_vars={})
    out = capsys.readouterr().out
    assert "best_tune" in out
    csv = (tmp_path / "w.csv").read_text()
    assert csv.count("\n") >= 2  # header + 2 ops


def test_cnn_op_info_mode(tmp_path, capsys):
    """Checkpoint A (SURVEY §7 stage 3): cnn_op_info over sgemm op sigs runs
    and cross-checks the default sgemm tune against the use_culibs one."""
    create_and_run_has_main(
        f"(mode=cnn_op_info,ops_fn={OPS_DIR}/sgemm-tiny.txt,run=1,run_iter=1,"
        f"comp_tune=(use_culibs=1),peak_flops=1e12)", global_vars={})
    out = capsys.readouterr().out
    assert "COMP_FAIL" not in out
    assert "sgemm" in out and "%peak" in out
    # static-only mode (no run) works and reports AI
    create_and_run_has_main(
        f"(mode=cnn_op_info,ops_fn={OPS_DIR}/conv-tiny.txt)", global_vars={})
    out = capsys.readouterr().out
    assert "AI" in out


def test_wisdom_drives_engine_tunes(tmp_path):
    """ops_prof wisdom feeds back into the rtc engine: matching op sigs get
    the recorded best tune (the reference's wisdom->engine loop)."""
    from boda_tpu.engine.iface import make_engine
    from boda_tpu.models.zoo import build_model
    from boda_tpu.tune.wisdom import (OpWisdom, load_tune_index,
                                      wisdom_key, write_wisdom_file)
    pipe = build_model("mini", batch=1, ysz=32, xsz=32)
    conv2 = pipe.get_op("conv2")  # 3x3 s1 -> default variant is conv
    w = OpWisdom(conv2.copy())
    tw = w.tune("(use_culibs=1)")  # recorded best: vendor xla_conv
    tw.add_run("xla:cpu", 1e-4)
    fn = tmp_path / "t.wis"
    write_wisdom_file(fn, [w])
    # index round-trip matches the graph op's key
    idx = load_tune_index(fn, "")
    assert wisdom_key(conv2) in idx
    eng = make_engine(f"(engine=rtc,fuse=0,wisdom_fn={fn})")
    eng.init(pipe)
    funcs = {s.call_tag: s.func_name for s in eng.plan.steps}
    assert funcs["conv2"] == "xla_conv"      # overridden by wisdom
    assert funcs["cccp1"] == "k1conv"        # untouched ops keep defaults


def test_sgemm_int8_quantized_matmul():
    """int8 matmul path (prec=int8): quantization error bounded, the
    built int8 dot matches the reference, variant selected by the tune."""
    import numpy as np
    from boda_tpu.ops.cnn_variants import add_codegen_annotations, make_op_tune
    from boda_tpu.ops.pallas.sgemm import make_sgemm_op
    from boda_tpu.ops.registry import get_template
    from boda_tpu.ops.op_base import OpBase
    from boda_tpu.core.dims import Dims
    op = OpBase({"type": "sgemm"})  # no func_name: let the tune pick
    op.set_dims("a", Dims.make(M=64, K=32))
    op.set_dims("b", Dims.make(K=32, N=48))
    op.set_dims("c", Dims.make(M=64, N=48))
    add_codegen_annotations(op, make_op_tune("(prec=int8)"))
    assert op.func_name == "sgemm_int8"
    tmpl = get_template("sgemm_int8")
    rfs = tmpl.check_args(op)
    rng = np.random.RandomState(0)
    a = rng.randn(64, 32).astype(np.float32)
    b = rng.randn(32, 48).astype(np.float32)
    exact = a @ b
    ref = tmpl.ref_impl(rfs, a, b)
    # quantization error vs exact: bounded by int8 resolution
    scale = np.abs(exact).max()
    assert np.abs(ref - exact).max() / scale < 0.05
    got = np.asarray(tmpl.build(rfs)(a, b))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_wisdom_ignores_nonpositive_secs():
    """Timing-noise artifacts (secs <= 0) must never be recorded or win
    best-tune selection (seen once in the r2 autotune sweep)."""
    from boda_tpu.ops.op_base import OpBase
    from boda_tpu.tune.wisdom import OpWisdom
    w = OpWisdom(OpBase({"type": "sgemm", "func_name": "sgemm"}))
    w.tune("(a=1)").add_run("p", -1e-4)
    w.tune("(b=1)").add_run("p", 5e-4)
    assert w.best_tune("p") == ("(b=1)", 5e-4)
    assert "p" not in w.tune("(a=1)").runs


def test_cnet_xprof_mode(tmp_path, capsys):
    # per-kernel device-event profile (reference nvrtc_util.cc:296 get_dur
    # parity): runs the fused mini net under jax.profiler, parses the
    # xplane, and reports per-HLO-op time. CPU publishes hlo_op-stat
    # events on the PJRT client lines, so the same parse works here.
    create_and_run_has_main(
        f"(mode=cnet_xprof,model=mini,batch=2,steps=2,"
        f"op_tune=(use_culibs=1,prec=f32),trace_dir={tmp_path}/trace,"
        f"boda_output_dir={tmp_path})",
        global_vars={})
    out = capsys.readouterr().out
    assert "cnet_xprof mini b2 steps=2" in out
    assert "device total:" in out and "-- by kind --" in out
    # a conv net's profile must be conv-dominated on some row
    assert "conv" in out
    # the raw trace was kept where asked
    from boda_tpu.tune.xprof import aggregate_xplane, find_xplane
    rows, meta = aggregate_xplane(find_xplane(tmp_path / "trace"))
    assert rows and all(r["count"] >= 2 for r in rows[:3])
    assert sum(r["total_ns"] for r in rows) > 0


def test_cnet_xprof_bwd(tmp_path, capsys):
    # --bwd profiles the training step (grad of the logits-sum loss);
    # the table must include backward kernels beyond the fwd set
    create_and_run_has_main(
        f"(mode=cnet_xprof,model=mini,batch=2,steps=2,bwd=1,"
        f"op_tune=(use_culibs=1,prec=f32),boda_output_dir={tmp_path})",
        global_vars={})
    out = capsys.readouterr().out
    assert "device total:" in out
    assert "conv" in out  # dgrad/wgrad convs dominate a conv net's bwd


def test_alexnet_b64_wisdom_artifact():
    """The checked-in autotune-closure artifact (VERDICT r4 #7: wisdom
    produced by ops_prof auto-sweep on a never-hand-tuned net/batch,
    then applied in-net via cnet_bench --wisdom-fn): parses, covers all
    8 alexnet b64 ops, each with at least one timed TPU record, and its
    tune index resolves against the lowered alexnet plan."""
    from pathlib import Path

    import pytest

    from boda_tpu.models.zoo import build_model
    from boda_tpu.tune.wisdom import (load_tune_index, lookup_tune,
                                      read_wisdom_file)
    fn = Path(__file__).parent / "data" / "wisdom-alexnet-b64.wis"
    if not fn.exists():
        pytest.skip("wisdom artifact not yet generated (on-chip ops_prof)")
    ws = read_wisdom_file(fn)
    assert len(ws) == 8
    # the artifact was measured on the TPU chip; its records carry that
    # plat tag (wisdom records are per-platform, op-tuner.H:11-46 parity)
    idx = load_tune_index(fn, "xla:tpu:TPU v5 lite")
    assert idx, "no TPU-plat tune records in the artifact"
    pipe = build_model("alexnet_ng_conv", batch=64)
    pipe.calc_dims()
    hits = sum(lookup_tune(idx, op) is not None
               for op in pipe.ops.values() if op.type == "Convolution")
    assert hits >= 5, (hits, sorted(idx)[:3])
