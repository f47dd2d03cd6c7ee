"""Per-op profiling + the ops-prof autotuning sweep driver.

Capability parity with rtc_prof.cc: profile_rcg_call (:44-137 — generate
one op, alloc its args, fill inputs with deterministic gen_data patterns,
run run_iter times with event timing) and mode ops-prof (:140-457 — for
each op in an op-sig file × each named tune × each backend: run, time,
cross-check outputs against the kg tune's full data AND against stored
known-good digests from input wisdom; write merged wisdom).
"""

from __future__ import annotations

import sys
from typing import Optional

from ..backend.iface import Backend, RtcFuncCall
from ..core.config import Attr
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.has_main import HasMain, mode
from ..ops.cnn_variants import OpTune, add_codegen_annotations, make_op_tune
from ..ops.op_base import OpBase, read_op_sigs
from ..ops.registry import Codegen, get_template
from ..testing.comp import comp_digests, comp_vars
from ..core.digest import nda_digest
from .wisdom import (OpWisdom, merge_wisdoms, read_wisdom_file,
                     write_wisdom_file)


def profile_rcg_call(cg: Codegen, op: OpBase, run_iter: int = 5,
                     var_prefix: str = "") -> tuple[float, dict[str, NDA]]:
    """Generate one op instance, alloc+fill args, run run_iter times; return
    (best secs, output tensors). Mirrors profile_rcg_call rtc_prof.cc:44."""
    be = cg.backend
    tmpl = get_template(op.func_name)
    rfs = tmpl.check_args(op)
    inst = cg.gen_func(op)
    args: dict[str, str] = {}
    made: list[str] = []
    try:
        gd = get_template("gen_data")
        i = -1  # pattern index counts PRESENT args, not declared positions:
        # an inserted optional decl (filts_scale) must not shift the test
        # patterns of later args — shipped wisdom artifacts pin kg digests
        # produced under the original in/filts/biases/out numbering
        for a in tmpl.args:
            if a.name not in rfs.nda_vals:
                continue
            dims = rfs.get_dims(a.name)
            if dims.tn == "none":
                continue
            i += 1
            vn = f"{var_prefix}{a.name}"
            if be.var_exists(vn) and be.get_var_dims(vn) != dims:
                # stale var from a prior profiled op (e.g. one whose
                # sweep errored mid-profile) — recreate at these dims
                be.release_var(vn)
            if not be.var_exists(vn):
                be.create_var_with_dims(vn, dims)
                made.append(vn)
            args[a.name] = vn
            if a.kind in ("IN", "INOUT"):
                gop = OpBase({"type": "gen_data", "func_name": "gen_data"})
                gop.set_dims("out", dims)
                gop.set_u32("mode", i % 4)
                gop.nda_vals["scale"] = NDA.scalar(0.1, "float")
                cg.gen_and_run(gop, {"out": vn})
        cg.compile_pend()
        best = None
        for _ in range(max(run_iter, 1)):
            cid = cg.run_func(RtcFuncCall(inst, args))
            be.finish_and_sync()
            dur = be.get_dur(cid, cid)
            best = dur if best is None else min(best, dur)
        outs = {a.name: be.copy_var_to_nda(args[a.name])
                for a in tmpl.args
                if a.kind in ("OUT", "INOUT") and a.name in args}
        return best, outs
    finally:
        # ALWAYS release — an errored tune used to leak 'in'/'filts' vars
        # that poisoned every later op's sweep with dim mismatches
        for vn in made:
            be.release_var(vn)


def _chained_secs(fn, in_vals, iters: int, reps: int = 3) -> float:
    """Per-iteration seconds for fn(*in_vals) with a serial dependency
    between iterations (defeats dispatch caching; scalar readback is the
    completion barrier).

    Timing is SLOPE-BASED: run the chain at two lengths n1 < n2 and take
    median (T(n2)-T(n1))/(n2-n1), which cancels the fixed per-dispatch
    and readback cost that total/iters folds into every op."""
    import statistics
    import time

    import jax
    import jax.numpy as jnp

    def chained(args, m):
        x0 = args[0]

        def body(c, _):
            if jnp.issubdtype(x0.dtype, jnp.floating) \
                    or x0.dtype == jnp.bfloat16:
                a0 = x0 + c.astype(x0.dtype)
            else:
                # integer inputs (int8 sgemm / quantized ops) must be
                # perturbed too, or the body is loop-invariant and XLA
                # hoists it out of the scan — the timed work runs ONCE
                # (c stays tiny, so the +0/+1 wobble can't overflow int8)
                a0 = x0 + (c.astype(jnp.int32) % 2).astype(x0.dtype)
            outs = fn(a0, *args[1:])
            o = outs[0] if isinstance(outs, (tuple, list)) else outs
            # consume the WHOLE output: a single-element readback lets
            # XLA's simplifier slice through elementwise producers and
            # dead-code-eliminate the very work being timed
            s = o.ravel().astype(jnp.float32).sum()
            return c + s * 1e-30, s

        c, ys = jax.lax.scan(body, jnp.float32(0), None, length=m)
        return ys.sum()

    ch = jax.jit(chained, static_argnums=1)

    def measure(n1, n2, reps=reps):
        float(ch(in_vals, n1))  # compile + warm
        float(ch(in_vals, n2))
        slopes = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(ch(in_vals, n1))
            t1 = time.perf_counter()
            float(ch(in_vals, n2))
            t2 = time.perf_counter()
            slopes.append(((t2 - t1) - (t1 - t0)) / (n2 - n1))
        return statistics.median(slopes)

    n2 = max(iters, 8)
    s = measure(max(2, n2 // 5), n2)
    # adaptive: µs-scale ops drown in dispatch jitter at short chains —
    # lengthen until the n2-n1 span covers enough device work that the
    # slope error is a few percent; scan compile time doesn't grow with
    # length, so a long chain only costs runtime (~4 x span per measure).
    target_span = 250e-3
    for _ in range(3):
        if s > 0 and s * n2 >= target_span:
            break
        if s > 0:
            n2 = min(2_000_000, max(n2 + 1, int(target_span / s)))
        else:
            # invalid slope: no usable per-iter estimate — grow geometrically
            n2 = min(2_000_000, n2 * 64)
        s = measure(max(2, n2 // 5), n2)
    return s


@mode("ops_prof", help="per-op tuning sweep: time each op x tune x backend, "
                       "cross-check outputs, write wisdom")
class OpsProf(HasMain):
    ops_fn = Attr(str, req=True, help="op-sig list file (one lexp per line)")
    rtcs = Attr(dict[str, Backend], default=None,
                help="named backends, e.g. (gpu=(be=xla),ref=(be=interp))")
    op_tunes = Attr(dict[str, OpTune], default=None,
                    help="named tunes, e.g. (kg=(use_culibs=1),t1=(prec=bf16))")
    kg_tune_tag = Attr(str, default="kg", help="tune whose outputs are ground truth")
    run_iter = Attr(int, default=5)
    mrd_toler = Attr(float, default=5e-4)
    func_mrd_toler = Attr(dict[str, float], default=None,
                          help="per-func-name tolerance overrides")
    wisdom_in_fn = Attr(str, default="", help="input wisdom (known-good digests)")
    wisdom_out_fn = Attr(str, default="", help="output (merged) wisdom file")
    write_kgs = Attr(bool, default=True, help="record kg digests in output wisdom")

    def main(self):
        ops = read_op_sigs(self.ops_fn)
        rtcs = self.rtcs or {"xla": __import__(
            "boda_tpu.backend.iface", fromlist=["make_backend"]).make_backend("xla")}
        for be in rtcs.values():
            be.ensure_init()
        tunes: dict[str, OpTune] = dict(self.op_tunes or {})
        if self.kg_tune_tag not in tunes:
            tunes[self.kg_tune_tag] = make_op_tune("(use_culibs=1)")
        wis_in: dict = {}
        if self.wisdom_in_fn:
            for w in read_wisdom_file(self.wisdom_in_fn):
                wis_in[w.op._key()] = w
        out_ws: list[OpWisdom] = []
        n_err = 0
        cgs = {bn: Codegen(be) for bn, be in rtcs.items()}
        for op in ops:
            w = OpWisdom(op)
            # the kg tune MUST run first: every other tune is cross-checked
            # against kg_outs, and a user tune ordered before kg would print
            # 'ok' without any output verification
            tune_items = sorted(tunes.items(),
                                key=lambda kv: kv[0] != self.kg_tune_tag)
            kg_outs: Optional[dict] = None
            for be_name, be in rtcs.items():
                cg = cgs[be_name]
                plat = be.get_plat_tag()
                for tname, tune in tune_items:
                    top = op.copy()
                    try:
                        add_codegen_annotations(top, tune)
                        secs, outs = profile_rcg_call(cg, top, self.run_iter)
                    except Exception as e:
                        # compile failures (e.g. device OOM from an oversized
                        # tune) are recorded, not fatal — the reference
                        # tagged OOM compile failures the same way
                        # (cnn-prof.cc:99-110)
                        msg = str(e).splitlines()[0][:200]
                        print(f"OP {op.type} tune={tname} be={be_name}: "
                              f"ERROR {type(e).__name__}: {msg}")
                        n_err += 1
                        continue
                    ftol = (self.func_mrd_toler or {}).get(top.func_name, self.mrd_toler)
                    status = "ok"
                    if tname == self.kg_tune_tag and kg_outs is None:
                        kg_outs = outs
                        if self.write_kgs:
                            for an, nda in outs.items():
                                w.kgs.setdefault(an, nda_digest(nda, self_cmp_mrd=ftol))
                    elif kg_outs is not None:
                        errs = comp_vars(kg_outs, outs, ftol)
                        if errs:
                            status = "COMP_FAIL: " + "; ".join(errs)
                            n_err += 1
                    else:
                        # the kg tune itself failed for this op — nothing
                        # to verify against; don't record unverified runs
                        status = "UNVERIFIED (kg tune produced no outputs)"
                    kw = wis_in.get(op._key())
                    if kw is not None and kw.kgs:
                        errs = comp_digests(outs, {k: v for k, v in kw.kgs.items()
                                                   if k in outs}, ftol)
                        if errs:
                            status += " KG_DIGEST_FAIL: " + "; ".join(errs)
                            n_err += 1
                    tmpl = get_template(top.func_name)
                    flops = tmpl.flops(tmpl.check_args(top))
                    gfs = flops / secs / 1e9 if secs else 0.0
                    print(f"OP {op.to_compact_lexp()} tune={tname} be={be_name} "
                          f"func={top.func_name} secs={secs:.3e} GF/s={gfs:.1f} {status}")
                    if status == "ok":
                        # wisdom records only VERIFIED timings: best_tune
                        # selects by min secs, so a fast-but-wrong tune
                        # (COMP_FAIL) must never enter the store
                        w.tune(str(tune.to_lexp())).add_run(plat, secs)
            out_ws.append(w)
        if self.wisdom_out_fn:
            merged = merge_wisdoms([list(wis_in.values()), out_ws]) if wis_in else out_ws
            write_wisdom_file(self.out_path(self.wisdom_out_fn), merged)
            print(f"wrote wisdom for {len(merged)} ops to {self.wisdom_out_fn}")
        if n_err:
            raise RtErr(f"ops_prof: {n_err} errors/comparison failures")
