"""In-net wisdom truth (VERDICT r2 #2): @net pseudo-platform runs, the
load_tune_index preference for them, and the fusion_penalty mode that
records them by measuring one-site-overridden whole-net times."""

from pathlib import Path

import pytest

from boda_tpu.core.has_main import create_and_run_has_main
from boda_tpu.models.zoo import build_model
from boda_tpu.ops.op_base import OpBase
from boda_tpu.tune.wisdom import (NET_PLAT_SUFFIX, OpWisdom, load_tune_index,
                                  lookup_tune, merge_wisdoms,
                                  read_wisdom_file, site_key, wisdom_key,
                                  write_wisdom_file)

PLAT = "xla:cpu:cpu"


def _sig():
    return OpBase.from_lexp(
        "(type=sgemm,dims_vals=(a=(M=64,K=64),b=(K=64,N=64),c=(M=64,N=64)))")


def test_load_tune_index_prefers_in_net_runs(tmp_path):
    w = OpWisdom(_sig())
    # standalone: hand tune wins big
    w.tune("(Mb=256)").add_run(PLAT, 1e-6)
    w.tune("(use_culibs=1)").add_run(PLAT, 9e-6)
    p = tmp_path / "w.wis"
    write_wisdom_file(p, [w])
    assert load_tune_index(p, PLAT)[wisdom_key(w.op)] == "(Mb=256)"
    # in-net: the hand kernel breaks fusion and loses -> vendor must win
    w.tune("(Mb=256)").add_run(PLAT + NET_PLAT_SUFFIX, 9e-5)
    w.tune("(use_culibs=1)").add_run(PLAT + NET_PLAT_SUFFIX, 2e-5)
    write_wisdom_file(p, [w])
    assert load_tune_index(p, PLAT)[wisdom_key(w.op)] == "(use_culibs=1)"
    # @net rows round-trip through the wire format
    w2 = read_wisdom_file(p)[0]
    assert w2.tunes["(Mb=256)"].runs[PLAT + NET_PLAT_SUFFIX] == pytest.approx(9e-5)


def test_fusion_penalty_mode_records_net_runs(tmp_path):
    pipe = build_model("mini", batch=2)
    op = pipe.get_op("conv2")
    w = OpWisdom(op.copy())
    # a fake standalone winner that differs from the vendor base
    w.tune("(prec=bf16)").add_run(PLAT, 1e-6)
    w.tune("(use_culibs=1)").add_run(PLAT, 5e-5)
    wfn = tmp_path / "w.wis"
    write_wisdom_file(wfn, [w])
    create_and_run_has_main(
        f"(mode=fusion_penalty,model=mini,batch=2,op_tune=(use_culibs=1),"
        f"wisdom_fn={wfn},iters=3,reps=1,boda_output_dir={tmp_path})")
    merged = read_wisdom_file(wfn)
    # @net rows land in a record PINNED to the site (VERDICT r3 weak #4);
    # the standalone sig record is left untouched
    rec = next(m for m in merged if wisdom_key(m.op) == wisdom_key(op)
               and m.site == "conv2")
    sig_rec = next(m for m in merged if wisdom_key(m.op) == wisdom_key(op)
                   and not m.site)
    net_plat = PLAT + NET_PLAT_SUFFIX
    assert net_plat in rec.tunes["(prec=bf16)"].runs
    assert net_plat in rec.tunes["(use_culibs=1)"].runs
    assert not any(net_plat in tw.runs for tw in sig_rec.tunes.values())
    # and the site-aware lookup now picks based on the in-net rows
    idx = load_tune_index(wfn, PLAT)
    pick = lookup_tune(idx, op)
    runs = {ts: tw.runs[net_plat] for ts, tw in rec.tunes.items()
            if net_plat in tw.runs}
    assert pick == min(runs, key=runs.get)


def _two_site_net(tmp_path):
    """A pipe with two IDENTICAL-sig conv sites (convA/convB) written out
    as a prototxt so modes can load it."""
    from boda_tpu.graph.caffe_io import write_prototxt
    from boda_tpu.models.zoo import NetBuilder
    b = NetBuilder("twosite", 2, 3, 16, 16)
    b.conv("conv1", 8, 3, 2, 1)
    b.conv("convA", 8, 3, 1, 1)
    b.conv("convB", 8, 3, 1, 1)
    b.conv("fc-conv", 4, 1, relu=False)
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.softmax("prob")
    pipe = b.done(seed=7)
    ptt = tmp_path / "twosite.prototxt"
    write_prototxt(pipe, ptt)
    return pipe, ptt


def test_fusion_penalty_per_site_records_diverge(tmp_path):
    """Two same-sig sites get INDEPENDENT @net records: the very point of
    per-site keys — one sig-level verdict cannot serve fusion-context-
    dependent decisions at two graph positions."""
    pipe, ptt = _two_site_net(tmp_path)
    opA, opB = pipe.get_op("convA"), pipe.get_op("convB")
    assert wisdom_key(opA) == wisdom_key(opB)  # identical signatures
    w = OpWisdom(opA.copy())
    w.tune("(prec=bf16)").add_run(PLAT, 1e-6)
    w.tune("(use_culibs=1)").add_run(PLAT, 5e-5)
    wfn = tmp_path / "w.wis"
    write_wisdom_file(wfn, [w])
    create_and_run_has_main(
        f"(mode=fusion_penalty,ptt_fn={ptt},op_tune=(use_culibs=1),"
        f"wisdom_fn={wfn},iters=3,reps=1,boda_output_dir={tmp_path})")
    merged = read_wisdom_file(wfn)
    net_plat = PLAT + NET_PLAT_SUFFIX
    recs = {m.site: m for m in merged if m.site}
    assert set(recs) == {"convA", "convB"}
    # both site records carry their own in-net rows for both tunes
    for m in recs.values():
        assert net_plat in m.tunes["(prec=bf16)"].runs
        assert net_plat in m.tunes["(use_culibs=1)"].runs
    # hand-diverge the verdicts (timing on CPU is noise): site A keeps the
    # override, site B refuses it — lookup_tune must resolve per site
    recs["convA"].tunes["(prec=bf16)"].runs[net_plat] = 1e-6
    recs["convA"].tunes["(use_culibs=1)"].runs[net_plat] = 2e-6
    recs["convB"].tunes["(prec=bf16)"].runs[net_plat] = 2e-6
    recs["convB"].tunes["(use_culibs=1)"].runs[net_plat] = 1e-6
    write_wisdom_file(wfn, merged)
    idx = load_tune_index(wfn, PLAT)
    assert lookup_tune(idx, opA) == "(prec=bf16)"
    assert lookup_tune(idx, opB) == "(use_culibs=1)"


def test_site_records_round_trip_and_merge(tmp_path):
    sig = _sig()
    w_sig = OpWisdom(sig)
    w_sig.tune("(Mb=256)").add_run(PLAT, 1e-6)
    w_site = OpWisdom(sig.copy(), site="res4a_branch2b")
    w_site.tune("(Mb=256)").add_run(PLAT + NET_PLAT_SUFFIX, 5e-6)
    p = tmp_path / "s.wis"
    write_wisdom_file(p, [w_sig, w_site])
    back = read_wisdom_file(p)
    assert [w.site for w in back] == ["", "res4a_branch2b"]
    # merge keys include the site: sig and site records never collapse,
    # same-(sig,site) records do
    w_site2 = OpWisdom(sig.copy(), site="res4a_branch2b")
    w_site2.tune("(Mb=256)").add_run(PLAT + NET_PLAT_SUFFIX, 4e-6)
    merged = merge_wisdoms([back, [w_site2]])
    assert len(merged) == 2
    site_rec = next(w for w in merged if w.site)
    assert site_rec.tunes["(Mb=256)"].runs[PLAT + NET_PLAT_SUFFIX] \
        == pytest.approx(4e-6)
    # index keys: site entry under site_key, plain key untouched
    write_wisdom_file(p, merged)
    idx = load_tune_index(p, "")
    assert wisdom_key(sig) in idx
    assert site_key(wisdom_key(sig), "res4a_branch2b") in idx


def test_shipped_wisdom_carries_net_rows():
    """The checked-in resnet-50 b32 wisdom fixture contains @net rows
    (a fusion_penalty run, recorded under its platform tag): the tune
    index must refuse the standalone hand-kernel winners for every sig
    that was measured in-net."""
    ws = read_wisdom_file(Path(__file__).parent / "data"
                          / "wisdom-resnet50-b32.wis")
    plat = "xla:tpu:TPU v5 lite"
    base = "(use_culibs=1,prec=bf16,layout=nhwc)"
    net_sigs = [w for w in ws if any(
        plat + NET_PLAT_SUFFIX in tw.runs for tw in w.tunes.values())]
    assert len(net_sigs) >= 3
    idx = load_tune_index(Path(__file__).parent / "data"
                          / "wisdom-resnet50-b32.wis", plat)
    refused = 0
    for w in net_sigs:
        runs = {ts: tw.runs[plat + NET_PLAT_SUFFIX]
                for ts, tw in w.tunes.items()
                if plat + NET_PLAT_SUFFIX in tw.runs}
        pick = idx[wisdom_key(w.op)]
        assert pick == min(runs, key=runs.get)
        if pick == base:
            refused += 1
    assert refused >= 2  # the measured in-net losers stay vendor
