"""cnn_op_info: per-op FLOPs/AI/roofline analysis + optional run/compare.

Capability parity with cnn-prof.cc:25-131 (mode cnn_op_info): for each op
in an op-sig file, report FLOPs, bytes, arithmetic intensity, and — with
--run=1 — measured time, achieved FLOP/s, and % of peak (peak_flops
defaulting to the current device's published peak rather than the reference's
hardcoded TITAN X 6.6 TF/s, cnn-prof.cc:36), optionally cross-checked
against a comparison tune (cuDNN role → use_culibs tune).
"""

from __future__ import annotations

from ..core.config import Attr
from ..core.error import RtErr
from ..core.has_main import HasMain, mode
from ..backend.iface import Backend
from ..ops.cnn_variants import OpTune, add_codegen_annotations, make_op_tune
from ..ops.op_base import read_op_sigs
from ..ops.registry import Codegen, get_template
from ..testing.comp import comp_vars


def op_bytes(rfs) -> int:
    n = 0
    for k, v in rfs.nda_vals.items():
        if v.dims.tn != "none":
            n += v.dims.bytes_sz()
    return n


def default_peak_flops(prec: str = "bf16") -> float:
    # single definition site: core/machine.py
    from ..core.machine import current_device_kind, peak_flops
    return peak_flops(current_device_kind(), prec)


def op_prec(sig, tune_prec: str = "") -> str:
    """The precision an annotated op sig actually computes in: int8 when
    the quant8 path is selected, else its prec annotation (falling back
    to the tune's), defaulting bf16. Used to score each op against ITS
    OWN precision peak (an int8 op scored against the bf16 peak reads
    twice as close to the roof as it is)."""
    if sig.get_u32_or("quant8", 0):
        return "int8"
    p = sig.str_vals.get("prec") or tune_prec or "bf16"
    return p if p in ("bf16", "f32", "int8") else "f32"


def plan_mixed_peak(plan, device_kind: str) -> tuple[float, float]:
    """Site-weighted mixed-precision roofline for a lowered plan: the
    effective peak = total_flops / Σ_i(flops_i / peak(prec_i)) — the
    rate a program hitting every site's own precision peak would achieve.
    Returns (plan_flops, effective_peak_flops). For a uniform-precision
    plan this is exactly that precision's peak; for the selective-int8
    preset it sits between the bf16 and int8 peaks, weighted by where
    the FLOPs are. (Reference: cnn-prof.cc:36 scores ops against a
    per-device-config peak_flops; the mixed peak is the per-PLAN analog.)
    """
    from ..core.machine import peak_flops
    from ..ops.registry import get_template
    tot = 0.0
    t_min = 0.0
    for s in plan.steps:
        try:
            fl = get_template(s.func_name).flops(s.sig)
        except Exception:
            continue
        if not fl:
            continue
        tot += fl
        t_min += fl / peak_flops(device_kind, op_prec(s.sig))
    return tot, (tot / t_min if t_min else 0.0)


@mode("cnn_op_info", help="per-op flops/AI/roofline report (+optional run)")
class CnnOpInfo(HasMain):
    ops_fn = Attr(str, req=True, help="op-sig list file")
    rtc = Attr(Backend, default="xla")
    op_tune = Attr(OpTune, default="()")
    comp_tune = Attr(OpTune, default=None, help="comparison tune (e.g. (use_culibs=1))")
    run = Attr(bool, default=False, help="also run+time each op")
    run_iter = Attr(int, default=5)
    peak_flops = Attr(float, default=0.0, help="peak FLOP/s (0=auto from device)")
    mrd_toler = Attr(float, default=5e-4)
    latex_fn = Attr(str, default="", help="also write a LaTeX table here "
                    "(reference: conv_op_info_to_latex_t, latex-util.H:22)")

    def get_ops(self):
        return read_op_sigs(self.ops_fn)

    def main(self):
        from .prof import profile_rcg_call
        ops = self.get_ops()
        cg = None
        if self.run:
            self.rtc.ensure_init()
            cg = Codegen(self.rtc)
        print(f"{'op':58s} {'func':12s} {'Mflops':>10s} {'MB':>8s} {'AI':>7s}"
              + (f" {'secs':>11s} {'GF/s':>9s} {'%peak':>6s}" if self.run else ""))
        n_err = 0
        rows = []
        for op in ops:
            top = op.copy()
            add_codegen_annotations(top, self.op_tune)
            tmpl = get_template(top.func_name)
            rfs = tmpl.check_args(top)
            fl = tmpl.flops(rfs)
            by = op_bytes(rfs)
            # %peak is against the op's OWN precision peak (int8 sites
            # score vs the int8 peak); explicit --peak-flops overrides
            line = (f"{str(op.to_compact_lexp())[:58]:58s} {top.func_name:12s} "
                    f"{fl / 1e6:10.1f} {by / 1e6:8.2f} {fl / max(by, 1):7.1f}")
            secs_gfs = None
            op_pk = 0.0
            if self.run:
                try:
                    secs, outs = profile_rcg_call(cg, top, self.run_iter)
                    gfs = fl / secs / 1e9 if secs > 0 else 0.0
                    secs_gfs = (secs, gfs)
                    op_pk = self.peak_flops or default_peak_flops(
                        op_prec(rfs, self.op_tune.prec))
                    line += f" {secs:11.3e} {gfs:9.1f} {100 * gfs * 1e9 / op_pk:6.2f}"
                    if self.comp_tune is not None:
                        cop = op.copy()
                        add_codegen_annotations(cop, self.comp_tune)
                        csecs, couts = profile_rcg_call(cg, cop, self.run_iter)
                        errs = comp_vars(couts, outs, self.mrd_toler)
                        line += f"  comp={csecs:.3e}({top.func_name} vs {cop.func_name})"
                        if errs:
                            line += " COMP_FAIL: " + "; ".join(errs)
                            n_err += 1
                except RtErr as e:
                    line += f" ERROR {e}"
                    n_err += 1
            print(line)
            rows.append((top.func_name, fl, by,
                         secs_gfs if self.run else None, op_pk))
        if self.latex_fn:
            with open(self.out_path(self.latex_fn), "w") as f:
                cols = "l r r r" + (" r r" if self.run else "")
                f.write("\\begin{tabular}{%s}\n" % cols)
                hdr = "op & MFLOPs & MB & AI"
                if self.run:
                    hdr += " & GF/s & \\%peak"
                f.write(hdr + " \\\\\n\\hline\n")
                for fn_name, fl, by, sg, row_pk in rows:
                    r = f"{fn_name} & {fl/1e6:.1f} & {by/1e6:.2f} & {fl/max(by,1):.1f}"
                    if self.run and sg:
                        r += f" & {sg[1]:.1f} & {100*sg[1]*1e9/row_pk:.2f}"
                    f.write(r + " \\\\\n")
                f.write("\\end{tabular}\n")
            print(f"wrote latex table to {self.latex_fn}")
        if n_err:
            raise RtErr(f"cnn_op_info: {n_err} errors")


@mode("cnn_prof", help="per-op profile of a NET's ops (no sig file needed)")
class CnnProf(CnnOpInfo):
    """Reference: mode cnn_prof (cnn-prof.cc:133-144) — run the per-op
    flops/AI/%peak analysis over the ops OF A MODEL rather than a
    hand-written op-sig list. The sigs come from the lowered graph (same
    dims the executor runs), optionally deduped by reduced signature."""

    ops_fn = Attr(str, default="", help="(unused; ops come from the model)")
    model = Attr(str, default="", help="zoo model name")
    ptt_fn = Attr(str, default="", help="or a prototxt path")
    batch = Attr(int, default=1)
    dedup = Attr(bool, default=True, help="collapse duplicate op sigs")
    sigs_out_fn = Attr(str, default="", help="also write the op-sig list "
                       "here (feeds ops_prof sweeps)")

    def get_ops(self):
        from ..graph.modes import _load_pipe
        from ..ops.op_base import write_op_sigs
        pipe = _load_pipe(self)
        ops = []
        seen = set()
        for op in pipe.topo_order():
            if op.type not in ("Convolution", "Deconvolution", "InnerProduct"):
                continue
            o = op.copy()
            o.str_vals.pop("caffe_name", None)
            if self.dedup:
                k = o._key()
                if k in seen:
                    continue
                seen.add(k)
            ops.append(o)
        if self.sigs_out_fn:
            write_op_sigs(self.out_path(self.sigs_out_fn), ops)
        return ops
