"""cnet_bench: slope-timed whole-net throughput benchmark for any model.

Generalizes bench.py (the driver's headline harness) into a CLI mode:
build any zoo/prototxt model, lower it with a tune (default: the shipped
perf config — fused NHWC/bf16-edge storage), chain iterations inside one
XLA program via a dynamic-length fori_loop, and report the slope between
two chain lengths (which cancels the fixed per-call dispatch cost).

Reference role: the whole-net half of cnn-prof (`cnn_prof`,
cnn-prof.cc:133) — per-net secs/imgs-per-sec/%-of-peak reporting.
"""

from __future__ import annotations

from ..core.config import Attr
from ..core.has_main import mode
from ..graph.modes import _NetMode
from ..ops.cnn_variants import OpTune

from ..core.machine import peak_flops  # single definition site (core/machine.py)


def frac_roofline(flops_per_s: float, dev, prec: str) -> str:
    """Share of the device's published peak for `prec`; a CPU run has no
    device peak, so it reports none."""
    if dev.platform == "cpu":
        return "n/a"
    return f"{flops_per_s / peak_flops(dev.device_kind, prec):.4f}"


def chained_net_secs(fwd, weights, x, iters: int, n1: int = 0, reps: int = 3,
                     compiler_options: dict | None = None,
                     data_node: str = "data", top: str = "prob"):
    """Per-forward seconds: serial fori_loop chain, slope of two lengths."""
    import statistics
    import time

    import jax
    import jax.numpy as jnp

    iters = max(iters, 3)
    n1 = n1 or max(2, iters // 5)
    n1 = min(n1, iters - 1)

    def chained(w, x, n):
        def body(_i, carry):
            c, acc = carry
            p = fwd({data_node: c}, w)[top]
            return c + p.sum().astype(c.dtype) * 1e-12, acc + p.ravel()[0]
        _c, acc = jax.lax.fori_loop(0, n, body, (x, jnp.float32(0)))
        return acc

    # per-jit XLA compiler overrides (e.g. xla_gpu_autotune_level): they
    # apply to this one program, where XLA_FLAGS would set the process
    fn = jax.jit(chained, compiler_options=compiler_options or None)
    dev = jax.devices()[0]
    w_dev = {k: jax.device_put(v, dev) for k, v in weights.items()}
    x_dev = jax.device_put(x, dev)
    t0 = time.perf_counter()
    float(fn(w_dev, x_dev, 1))
    compile_s = time.perf_counter() - t0
    float(fn(w_dev, x_dev, n1))
    float(fn(w_dev, x_dev, iters))
    slopes = []
    for _ in range(reps):
        a = time.perf_counter()
        float(fn(w_dev, x_dev, n1))
        b = time.perf_counter()
        float(fn(w_dev, x_dev, iters))
        c = time.perf_counter()
        slopes.append(((c - b) - (b - a)) / (iters - n1))
    return statistics.median(slopes), compile_s


@mode("cnet_tune", help="whole-net tune search: sweep tune records, pick best")
class CnetTune(_NetMode):
    """Whole-net autotuning (an addition to the reference, whose wisdom
    sweep is per-op; net-level knobs — layout/edge storage/first-layer
    transform — interact through XLA fusion, so a knob that wins per-op
    can lose in-net). Sweeps tune records with the chained-slope harness
    and reports/records the winner."""

    tunes = Attr(list[str], default=None,
                 help="tune records to sweep (default: a storage/layout/"
                      "s2d grid over the vendor kernels)")
    batches = Attr(list[int], default=None,
                   help="also sweep batch sizes (default: just --batch)")
    iters = Attr(int, default=30)
    reps = Attr(int, default=3)
    wisdom_out_fn = Attr(str, default="", help="write winner tune here")

    DEFAULT_TUNES = [
        "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)",
        "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0)",
        "(use_culibs=1,prec=bf16,layout=nhwc)",
        "(use_culibs=1,prec=bf16,layout=nhwc,edge_prec=f32,s2d=0)",
        "(use_culibs=1,prec=bf16)",
    ]

    def main(self):
        import numpy as np

        from ..backend.xla import enable_compilation_cache
        from ..engine.lower import lower_pipe, resolve_plan_weights
        from ..engine.rtc_fwd import build_fused_forward
        from ..graph.modes import _load_pipe
        from ..ops.cnn_variants import make_op_tune

        enable_compilation_cache()
        results = []  # (imgs_per_sec, batch, tune)
        for bsz in (self.batches or [self.batch]):
            self.batch = bsz
            pipe = _load_pipe(self)
            d = pipe.get_data_img_dims()
            x = (np.random.RandomState(0).randn(*d.shape) * 0.1
                 ).astype(np.float32)
            fl, _ = pipe.total_flops_and_bytes()
            for ts in (self.tunes or self.DEFAULT_TUNES):
                plan = lower_pipe(pipe, make_op_tune(ts), fused_storage=True)
                fwd = build_fused_forward(plan)
                weights = resolve_plan_weights(plan, pipe.op_params)
                secs, _c = chained_net_secs(
                    fwd, weights, x, self.iters, reps=self.reps,
                    data_node=pipe.data_img_node_names[0],
                    top="prob" if "prob" in plan.output_nodes
                    else plan.output_nodes[-1])
                ips = d["img"] / secs
                results.append((ips, bsz, ts))
                print(f"b{bsz} tune {ts}: step_ms={secs * 1e3:.2f} "
                      f"imgs_per_sec={ips:.1f} "
                      f"tflops={fl / secs / 1e12:.1f}", flush=True)
        results.sort(key=lambda r: -r[0])
        best_ips, best_b, best = results[0]
        print(f"best: batch={best_b} tune={best} "
              f"(imgs_per_sec={best_ips:.1f})")
        if self.wisdom_out_fn:
            with open(self.out_path(self.wisdom_out_fn), "w") as f:
                f.write(f"(model={self.model},batch={best_b},tune={best})\n")


@mode("fusion_penalty",
      help="measure per-op-site in-net penalty of wisdom overrides; "
           "record @net times so wisdom picks in-net winners")
class FusionPenalty(_NetMode):
    """VERDICT r2 #2: ops_prof writes STANDALONE times into wisdom, but an
    opaque pallas call inside the fused whole-net program breaks XLA's
    cross-op fusion — standalone winners can lose in-net (measured r2:
    wisdom-tuned 4.09 ms vs vendor 2.53 ms, resnet-50 b32). This mode
    measures the truth: for each op site where the wisdom file's
    standalone pick differs from the vendor base, lower the net with ONLY
    that site overridden, slope-time the whole net, and record

        in_net(op, tune)   = standalone_vendor(op) + (net_tune - net_vendor)
        in_net(op, vendor) = standalone_vendor(op)

    under the pseudo-platform `<plat>@net` (same wire format, merged into
    the wisdom file). load_tune_index prefers @net runs, so subsequent
    `rtc_fwd --wisdom-fn` / `cnet_bench --wisdom-fn` runs pick in-net
    winners — or keep vendor, refusing the override with data."""

    op_tune = Attr(OpTune,
                   default="(use_culibs=1,prec=bf16,layout=nhwc,s2d=0)",
                   help="vendor base tune")
    wisdom_fn = Attr(str, req=True, help="wisdom file (ops_prof output)")
    wisdom_out_fn = Attr(str, default="", help="write merged wisdom here "
                         "(default: update wisdom_fn in place)")
    iters = Attr(int, default=20)
    reps = Attr(int, default=3)
    max_sites = Attr(int, default=0, help="limit measured sites (0=all)")

    def main(self):
        import numpy as np

        from ..backend.iface import make_backend
        from ..backend.xla import enable_compilation_cache
        from ..engine.lower import lower_pipe, resolve_plan_weights
        from ..engine.rtc_fwd import build_fused_forward
        from ..graph.modes import _load_pipe
        from ..ops.cnn_variants import make_op_tune
        from ..tune.wisdom import (NET_PLAT_SUFFIX, OpWisdom,
                                   load_tune_index, lookup_tune,
                                   read_wisdom_file, wisdom_key,
                                   write_wisdom_file)

        enable_compilation_cache()
        be = make_backend("xla")
        be.init()
        plat = be.get_plat_tag()
        pipe = _load_pipe(self)
        idx = load_tune_index(self.wisdom_fn, plat) or \
            load_tune_index(self.wisdom_fn, "")
        base_spec = str(self.op_tune.to_lexp())
        # candidate sites: graph ops whose best tune (site-aware: an
        # earlier fusion_penalty run's per-site verdict wins over the
        # standalone per-sig pick) != base
        sites = []
        for op in pipe.ops.values():
            ts = lookup_tune(idx, op)
            if ts is not None and ts != base_spec:
                sites.append((op.tag, ts, op))
        if self.max_sites:
            sites = sites[:self.max_sites]
        print(f"fusion_penalty: {len(sites)} candidate site(s) on {plat}",
              flush=True)

        d = pipe.get_data_img_dims()
        x = (np.random.RandomState(0).randn(*d.shape) * 0.1).astype(np.float32)

        def net_secs(op_tunes):
            plan = lower_pipe(pipe, self.op_tune, op_tunes=op_tunes,
                              fused_storage=True)
            fwd = build_fused_forward(plan)
            weights = resolve_plan_weights(plan, pipe.op_params)
            secs, _c = chained_net_secs(
                fwd, weights, x, self.iters, reps=self.reps,
                data_node=pipe.data_img_node_names[0],
                top="prob" if "prob" in plan.output_nodes
                else plan.output_nodes[-1])
            return secs

        vendor_secs = net_secs(None)
        print(f"vendor net: {vendor_secs * 1e3:.3f} ms", flush=True)

        # standalone vendor per-op times from the wisdom file (base offset)
        wis_in = read_wisdom_file(self.wisdom_fn)
        standalone_vendor = {}
        for w in wis_in:
            if w.site:  # site records carry in-net rows, not standalone
                continue
            tw = w.tunes.get(base_spec)
            if tw:
                s = tw.runs.get(plat) or min(
                    (v for p, v in tw.runs.items()
                     if not p.endswith(NET_PLAT_SUFFIX)), default=None)
                if s:
                    standalone_vendor[wisdom_key(w.op)] = s

        # index the input wisdom records by (wisdom_key, site) so @net runs
        # land in the SAME record ops_prof wrote (the graph op accumulates
        # lowering annotations, so exact-sig merging would duplicate records)
        wis_by_key = {(wisdom_key(w.op), w.site): w for w in wis_in}
        n_rec = 0
        print(f"{'site':24s} {'tune':44s} {'net ms':>9s} {'delta us':>9s} verdict")
        for tag, ts, op in sites:
            s = net_secs({tag: make_op_tune(ts)})
            delta = s - vendor_secs
            key = wisdom_key(op)
            base = standalone_vendor.get(key, 1e-6)
            # @net verdicts are fusion-context-dependent, so they go into a
            # record pinned to THIS site (VERDICT r3 weak #4): same-sig
            # sites at other graph positions keep their own verdicts (or
            # the per-sig standalone pick until measured here)
            w = wis_by_key.get((key, tag))
            if w is None:
                src = wis_by_key.get((key, ""))
                if src is None:  # shouldn't happen (site came from the index)
                    continue
                w = OpWisdom(src.op, site=tag)
                wis_by_key[(key, tag)] = w
                wis_in.append(w)
            w.tune(ts).add_run(plat + NET_PLAT_SUFFIX,
                               max(1e-9, base + delta), keep_best=False)
            w.tune(base_spec).add_run(plat + NET_PLAT_SUFFIX, base,
                                      keep_best=False)
            n_rec += 1
            verdict = "WINS" if delta < 0 else "loses (vendor kept)"
            print(f"{tag:24s} {ts:44.44s} {s * 1e3:9.3f} {delta * 1e6:9.1f} "
                  f"{verdict}", flush=True)
        out_fn = self.wisdom_out_fn or self.wisdom_fn
        write_wisdom_file(self.out_path(out_fn) if self.wisdom_out_fn
                          else out_fn, wis_in)
        print(f"fusion_penalty: merged @net runs for {n_rec} site(s) "
              f"-> {out_fn}")


@mode("cnet_stage_probe",
      help="isolated per-stage slope-timed floors (ceiling-proof table)")
class CnetStageProbe(_NetMode):
    """VERDICT r2 #1: a quantitative ceiling proof for the headline net —
    partition the lowered plan into stages by call-tag prefix, build each
    stage as its own jitted segment (same storage-NHWC interior form as
    the shipped program), slope-time each in isolation, and print the
    floor table whose sum brackets the shipped whole-net step time."""

    op_tune = Attr(OpTune,
                   default="(use_culibs=1,prec=bf16,layout=nhwc,s2d=0)")
    stages = Attr(str,
                  default="stem:conv1+pool1|s2:res2|s3:res3|s4:res4|"
                          "s5:res5|head:pool5+fc1000-conv+prob",
                  help="stage spec: name:prefix[+prefix...]|... matched "
                       "against step call tags in plan order ('+' joins "
                       "prefixes — ',' is lexp syntax)")
    iters = Attr(int, default=24)
    reps = Attr(int, default=3)
    whole_net = Attr(bool, default=True, help="also time the whole net")
    bwd = Attr(bool, default=False,
               help="probe TRAINING floors: per-stage fwd+bwd (input-grad "
                    "+ weight-grad via the mxu_grad custom VJP), 3x-fwd "
                    "flops estimate — the per-stage view of train_bench")

    def main(self):
        import numpy as np

        from ..backend.xla import enable_compilation_cache
        from ..engine.lower import lower_pipe, resolve_plan_weights
        from ..engine.rtc_fwd import build_fused_forward
        from ..graph.modes import _load_pipe
        from ..tune.prof import _chained_secs

        enable_compilation_cache()
        pipe = _load_pipe(self)
        plan = lower_pipe(pipe, self.op_tune, fused_storage=True)
        weights = resolve_plan_weights(plan, pipe.op_params)
        from ..engine.segments import build_plan_segments
        segments = build_plan_segments(plan, weights, self.stages,
                                       what="cnet_stage_probe")
        d = pipe.get_data_img_dims()
        x0 = (np.random.RandomState(0).randn(*d.shape) * 0.1).astype(np.float32)
        # run the whole net once, jitted, to capture each stage's input value
        import jax
        whole = build_fused_forward(plan, keep_all_nodes=True)
        all_vals = jax.jit(lambda i, w: whole(i, w))({"data": x0}, weights)

        print(f"{'stage':8s} {'steps':>5s} {'ms':>9s} {'GF':>9s} {'TF/s':>7s}")
        total = 0.0
        rows = []
        for ps in segments:
            name, seg = ps.name, ps.steps
            seg_fn, in_node = ps.fn, ps.in_node
            seg_weights, flops = ps.weight_names, ps.flops
            # stage input in INTERIOR storage form: take it from the
            # whole-net keep_all_nodes values, re-converting to storage
            from ..engine.rtc_fwd import _storage_in
            if in_node == "data":
                xin = _storage_in(x0, plan)
            else:
                xin = _storage_in(np.asarray(all_vals[in_node]), plan)
            ws = [weights[n] for n in seg_weights]
            timed_fn = seg_fn
            if self.bwd:
                # per-stage fwd+bwd floor: grad of a whole-output-sum loss
                # w.r.t. the stage input AND its weights (dgrad + wgrad
                # convs both run). Every grad leaf feeds the returned
                # scalar — a partial readback would let XLA dead-code the
                # weight-grad pass (the round-1 single-element lesson).
                import jax.numpy as jnp

                def seg_loss(x, wt, _seg=seg_fn):
                    return _seg(x, *wt).ravel().astype(jnp.float32).sum()

                # a real train step never differentiates w.r.t. the image,
                # so data-fed stages skip the input grad — UNLESS the stage
                # has no weights at all (pool/preprocessing-only): an empty
                # grad tuple makes timed_fn a constant, the scan body goes
                # loop-invariant, and XLA hoists the timed work (ADVICE r3)
                data_fed = in_node == "data" or \
                    in_node in pipe.data_img_node_names
                want_dgrad = (not data_fed) or not seg_weights
                argnums = tuple(a for a, use in
                                ((0, want_dgrad), (1, bool(seg_weights)))
                                if use)
                grad_fn = jax.grad(seg_loss, argnums=argnums)

                def timed_fn(x, *wt, _g=grad_fn, _dg=want_dgrad):
                    gs = _g(x, wt)
                    tot = jnp.float32(0)
                    if _dg:
                        tot = tot + gs[0].ravel().astype(jnp.float32).sum()
                        gs = gs[1:]
                    for gws in gs:
                        for g in gws:
                            tot = tot + g.ravel().astype(jnp.float32).sum()
                    return tot

                # fwd (+ input-grad for interior stages) (+ weight-grad)
                flops *= 1 + int(want_dgrad) + int(bool(seg_weights))
            secs = _chained_secs(timed_fn, [xin] + ws, self.iters,
                                 reps=self.reps)
            total += secs
            tfs = flops / secs / 1e12 if secs > 0 else 0.0
            rows.append((name, len(seg), secs, flops))
            print(f"{name:8s} {len(seg):5d} {secs * 1e3:9.3f} "
                  f"{flops / 1e9:9.2f} {tfs:7.1f}", flush=True)
        print(f"{'SUM':8s} {'':5s} {total * 1e3:9.3f}")
        if self.whole_net:
            data_node = pipe.data_img_node_names[0]
            if self.bwd:
                import jax.numpy as jnp
                top = ("prob" if "prob" in plan.output_nodes
                       else plan.output_nodes[-1])
                # backprop from the pre-softmax LOGITS, as cnet_train does:
                # the softmax VJP of an all-ones cotangent is p*(1-sum(p))
                # ~= 0, which would run the whole backward on near-zero
                # cotangents (valid as a pure timing floor, but divergent
                # from the training loss shape — ADVICE r3)
                top_op = next((op for op in pipe.ops.values()
                               if top in op.tops), None)
                if top_op is not None and top_op.type == "Softmax":
                    top = top_op.bots[0]
                # extra_out_nodes, NOT keep_all_nodes: keeping every node
                # fetchable defeats whole-net fusion (362 vs ~40 ms
                # measured) — only the logits node needs surfacing
                fwd = build_fused_forward(
                    plan, extra_out_nodes=(top,)
                    if top not in plan.output_nodes else ())

                def net_loss(w, xb):
                    return fwd({data_node: xb}, w)[top] \
                        .ravel().astype(jnp.float32).sum()

                ngrad = jax.grad(net_loss)

                def net_bwd(x, w, _g=ngrad):
                    g = _g(w, x)
                    tot = jnp.float32(0)
                    for v in jax.tree_util.tree_leaves(g):
                        tot = tot + v.ravel().astype(jnp.float32).sum()
                    return tot

                secs = _chained_secs(net_bwd, [x0, weights], self.iters,
                                     reps=self.reps)
            else:
                fwd = build_fused_forward(plan)
                secs, _c = chained_net_secs(fwd, weights, x0, self.iters,
                                            reps=self.reps,
                                            data_node=data_node)
            print(f"{'WHOLE':8s} {'':5s} {secs * 1e3:9.3f}   "
                  f"(isolated-sum / whole = {total / secs:.3f})")


def pat_tunes(pipe, op_tunes_pat: dict):
    """Resolve per-op tune overrides by TAG REGEX onto a pipe's ops
    (shared by cnet_bench and train_bench)."""
    import re

    from ..ops.cnn_variants import make_op_tune
    out = {}
    for pat, spec in op_tunes_pat.items():
        rx = re.compile(pat)
        t = make_op_tune(spec)
        for op in pipe.ops.values():
            if rx.fullmatch(op.tag):
                out[op.tag] = t
    print(f"op_tunes_pat: tuned {len(out)} op(s)", flush=True)
    return out or None


@mode("cnet_bench", help="slope-timed whole-net throughput benchmark")
class CnetBench(_NetMode):
    op_tune = Attr(OpTune,
                   default="(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,"
                           "fuse_siblings=1)",
                   help="tune record (default: shipped perf config)")
    wisdom_fn = Attr(str, default="", help="per-op wisdom overrides "
                     "(ops_prof output; sigs must match this batch)")
    op_tunes_pat = Attr(dict[str, str], default=None,
                        help="per-op tune overrides by TAG REGEX, e.g. "
                             "(res2.*=(use_culibs=1,prec=bf16,layout=nhwc,"
                             "quant8=1)) — selective-stage experiments")
    act_scales_fn = Attr(str, default="",
                         help="calibrated static int8 activation scales "
                              "(tune/presets save_act_scales output) "
                              "applied onto the per-op tunes")
    iters = Attr(int, default=30, help="long chain length")
    reps = Attr(int, default=3, help="slope repetitions (median)")
    compiler_options = Attr(dict[str, str], default=None,
                            help="per-jit XLA compiler overrides, e.g. "
                                 "(xla_gpu_autotune_level=4)")

    def _pat_tunes(self, pipe):
        return pat_tunes(pipe, self.op_tunes_pat)

    def _wisdom_tunes(self, pipe):
        from ..backend.iface import make_backend
        from ..ops.cnn_variants import make_op_tune
        from ..tune.wisdom import load_tune_index, lookup_tune
        be = make_backend("xla")
        be.init()
        plat = be.get_plat_tag()
        idx = load_tune_index(self.wisdom_fn, plat)
        idx_any = load_tune_index(self.wisdom_fn, "")
        out = {}
        for op in pipe.ops.values():
            ts = lookup_tune(idx, op) or lookup_tune(idx_any, op)
            if ts is not None:
                out[op.tag] = make_op_tune(ts)
        print(f"wisdom: tuned {len(out)} op(s) from {self.wisdom_fn}",
              flush=True)
        return out or None

    def _build_fused(self):
        """Load the net, resolve tunes, lower + build the fused forward.

        Returns (pipe, plan, fwd, weights, x) — shared by the timing main
        and by subclass modes (cnet_xprof) that drive the same net
        differently."""
        import numpy as np

        from ..backend.xla import enable_compilation_cache
        from ..engine.lower import lower_pipe, resolve_plan_weights
        from ..engine.rtc_fwd import build_fused_forward
        from ..graph.modes import _load_pipe

        enable_compilation_cache()
        pipe = _load_pipe(self)
        op_tunes = self._wisdom_tunes(pipe) if self.wisdom_fn else None
        if self.op_tunes_pat:
            op_tunes = {**(op_tunes or {}), **(self._pat_tunes(pipe) or {})}
        if self.act_scales_fn:
            if not op_tunes:
                from ..core.error import RtErr
                raise RtErr("act_scales_fn requires per-op tunes "
                            "(--op-tunes-pat or --wisdom-fn) naming the "
                            "quant8 sites the scales apply to")
            from ..tune.presets import load_act_scales
            op_tunes = load_act_scales(self.act_scales_fn, op_tunes)
        plan = lower_pipe(pipe, self.op_tune, op_tunes=op_tunes,
                          fused_storage=True)
        fwd = build_fused_forward(plan)
        weights = resolve_plan_weights(plan, pipe.op_params)
        d = pipe.get_data_img_dims()
        x = (np.random.RandomState(0).randn(*d.shape) * 0.1).astype(np.float32)
        return pipe, plan, fwd, weights, x

    def main(self):
        pipe, plan, fwd, weights, x = self._build_fused()
        d = pipe.get_data_img_dims()

        secs, compile_s = chained_net_secs(
            fwd, weights, x, self.iters, reps=self.reps,
            compiler_options=self.compiler_options,
            data_node=pipe.data_img_node_names[0],
            top="prob" if "prob" in plan.output_nodes
            else plan.output_nodes[-1])
        import jax
        dev = jax.devices()[0]
        prec = self.op_tune.prec or "f32"
        fl, _ = pipe.total_flops_and_bytes()
        name = self.model or self.ptt_fn
        print(f"cnet_bench {name} b{d['img']} {prec} "
              f"storage={'nhwc' if plan.storage_nhwc else 'nchw'}: "
              f"step_ms={secs * 1e3:.2f} imgs_per_sec={d['img'] / secs:.1f} "
              f"tflops={fl / secs / 1e12:.1f} "
              f"frac_roofline={frac_roofline(fl / secs, dev, prec)} "
              f"compile_s={compile_s:.1f} device={dev.device_kind}")


@mode("pyra_bench", help="conv_pyra throughput: host pyramid pack + "
                         "device packed-bin forward, slope-timed")
class PyraBench(_NetMode):
    """BASELINE config #5 (conv_pyra multi-scale dense inference;
    reference conv_pyra.cc:24 ran it live from a camera): pyramid-pack
    frames on the host (blf_pack) and slope-time the packed-bin batch
    forward on device with the shipped fused config. Reports host
    pack ms/frame, device fwd ms/frame, and frames/sec both serial
    (pack then fwd) and overlapped (pack pipelined with device work —
    the steady-state streaming rate)."""

    op_tune = Attr(OpTune,
                   default="(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,"
                           "fuse_siblings=1)",
                   help="tune record (default: shipped perf config)")
    out_node = Attr(str, default="",
                    help="feature node defining the net + support pad "
                         "(default: deepest finite-support node)")
    bin_sz = Attr(list[int], default="288 288")
    interval = Attr(int, default=3)
    min_sz = Attr(int, default=32)
    pack_reps = Attr(int, default=5, help="host pack timing repetitions")
    pack = Attr(str, default="host",
                help="host = blf-pack on CPU (PIL parity path) then upload "
                     "the packed bins; device = upload the raw frame and "
                     "fuse resample+pack into the forward program "
                     "(make_device_pyra_pack) — one jit, device-bound "
                     "streaming rate")
    iters = Attr(int, default=30)
    reps = Attr(int, default=3)

    def main(self):
        import time as _time

        import numpy as np

        from ..backend.xla import enable_compilation_cache
        from ..core.geom import Pt
        from ..engine.lower import lower_pipe, resolve_plan_weights
        from ..engine.rtc_fwd import build_fused_forward
        from ..graph.modes import _load_pipe
        from ..io.img import img_to_chw, make_test_pattern_img
        from ..models.zoo import build_model
        from .pyra import ImgPyraPack

        enable_compilation_cache()
        pipe = _load_pipe(self)
        bin_yx = self.bin_sz
        out_node = None
        if self.out_node:
            out_node = pipe.must_get_node(self.out_node)
        else:
            # deepest finite-support node whose support pad still leaves
            # room in the bin (pad <= bin/2 per axis) — the densest
            # feature surface the pyramid can actually pack
            for op in pipe.topo_order():
                for t in op.tops:
                    n = pipe.must_get_node(t)
                    if (n.csi.valid() and not n.csi.support_sz.is_zeros()
                            and n.csi.support_sz.y <= bin_yx[0] // 2
                            and n.csi.support_sz.x <= bin_yx[1] // 2):
                        out_node = n
        if out_node is None or not out_node.csi.valid() \
                or out_node.csi.support_sz.is_zeros():
            from ..core.error import RtErr
            raise RtErr("pyra_bench: no finite-support node; pick one via "
                        "--out-node")
        d0 = pipe.get_data_img_dims()
        in_sz = Pt(d0["y"], d0["x"])
        bin_sz = Pt(*self.bin_sz)
        csi = out_node.csi
        pad = Pt(max(csi.support_sz.y, 1), max(csi.support_sz.x, 1))
        pp = ImgPyraPack(in_sz, bin_sz, self.interval, self.min_sz, pad)
        if self.model:
            bpipe = build_model(self.model, batch=pp.num_bins,
                                ysz=bin_sz.y, xsz=bin_sz.x)
            bpipe.op_params = pipe.op_params
        else:
            from ..core.dims import Dims
            self.in_dims = Dims.make(img=pp.num_bins, chan=3,
                                     y=bin_sz.y, x=bin_sz.x)
            bpipe = _load_pipe(self)
        bpipe = bpipe.pruned_to(out_node.name)
        plan = lower_pipe(bpipe, self.op_tune, fused_storage=True)
        fwd = build_fused_forward(plan)
        weights = resolve_plan_weights(plan, bpipe.op_params)

        img = make_test_pattern_img(in_sz.y, in_sz.x, 2)
        data_node = bpipe.data_img_node_names[0]
        top = out_node.name
        if self.pack == "device":
            from ..io.device_preproc import make_device_pyra_pack
            dpack = make_device_pyra_pack(pp)
            t0 = _time.perf_counter()
            for _ in range(self.pack_reps):  # host cost: frame staging only
                feed = np.ascontiguousarray(img, np.float32)
            pack_s = (_time.perf_counter() - t0) / self.pack_reps

            def bench_fwd(blobs, w):
                return {"prob": fwd({data_node: dpack(blobs["data"])},
                                    w)[top]}
        else:
            t0 = _time.perf_counter()
            for _ in range(self.pack_reps):
                packed = pp.scale_and_pack_img_into_bins(img)
                feed = np.stack([img_to_chw(packed[b])
                                 for b in range(pp.num_bins)])
            pack_s = (_time.perf_counter() - t0) / self.pack_reps

            def bench_fwd(blobs, w):
                return {"prob": fwd({data_node: blobs["data"]}, w)[top]}
        secs, compile_s = chained_net_secs(
            bench_fwd, weights, feed.astype(np.float32), self.iters,
            reps=self.reps)
        import jax
        dev = jax.devices()[0]
        fl, _ = bpipe.total_flops_and_bytes()
        prec = self.op_tune.prec or "f32"
        serial = 1.0 / (pack_s + secs)
        overlap = 1.0 / max(pack_s, secs)
        print(f"pyra_bench {self.model or self.ptt_fn} in={in_sz.y}x{in_sz.x}"
              f" bins={pp.num_bins}x{bin_sz.y}x{bin_sz.x} "
              f"scales={len(pp.scales)} out={top} {prec} pack={self.pack}: "
              f"pack_ms={pack_s * 1e3:.2f} fwd_ms={secs * 1e3:.2f} "
              f"frames_per_sec={serial:.1f} overlapped={overlap:.1f} "
              f"tflops={fl / secs / 1e12:.1f} "
              f"frac_roofline={frac_roofline(fl / secs, dev, prec)} "
              f"compile_s={compile_s:.1f} device={dev.device_kind}")


@mode("train_bench", help="slope-timed training-step benchmark "
                          "(fwd + bwd + SGD update, weights chained)")
class TrainBench(_NetMode):
    """Training-step throughput on the SAME fused forward the inference
    engine runs: jax.value_and_grad differentiates the lowered program
    directly (the training path; the explicit backward-ops IR
    — reference conv_util.cc add_bck_ops parity — lives in
    graph/pipe.add_bck_ops and engine tests). SGD steps are chained by
    CARRYING THE WEIGHTS through a fori_loop, so iterations are serially
    dependent and the two-length slope cancels the fixed dispatch cost.
    Reported tflops uses the standard 3x
    forward-flops estimate for fwd+bwd.

    Default tune is the shipped bf16 inference config: the bf16xbf16->
    f32 convs carry a mixed-precision custom VJP (ops/mxu_grad.mxu_conv)
    whose gradient convs are themselves bf16 with f32 accumulation — f32
    master weights, bf16 compute, the standard recipe. An f32 tune (prec
    unset) measures the full-f32 path, which ops/precision.dot_precision
    deliberately runs at HIGHEST precision (no TF32). quant8
    sites are inference-only; don't add them — the TRAINING int8 knob is
    grad_q8 (int8 weight-gradient convs, per-site via --op-tunes-pat)."""

    op_tune = Attr(OpTune,
                   default="(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,"
                           "fuse_siblings=1)",
                   help="tune record (default: shipped bf16 config; "
                        "grads via the mxu_grad custom VJP)")
    op_tunes_pat = Attr(dict[str, str], default=None,
                        help="per-op tune overrides by TAG REGEX (e.g. "
                             "(res[45].*=(use_culibs=1,prec=bf16,layout="
                             "nhwc,grad_q8=1)) — selective int8-wgrad "
                             "training experiments)")
    lr = Attr(float, default=0.01)
    optimizer = Attr(str, default="sgd",
                     help="sgd | momentum | adam (optimizer state "
                          "carried through the chain)")
    momentum = Attr(float, default=0.9)
    weight_decay = Attr(float, default=0.0,
                        help="L2 regularization (caffe weight_decay); "
                             "0 = off")
    iters = Attr(int, default=20, help="long chain length")
    reps = Attr(int, default=3, help="slope repetitions (median)")
    compiler_options = Attr(dict[str, str], default=None,
                            help="per-jit XLA compiler overrides")
    remat = Attr(bool, default=False,
                 help="gradient checkpointing: store only stage-boundary "
                      "activations, recompute stage interiors in bwd "
                      "(build_remat_forward; ~1 extra fwd of FLOPs for "
                      "O(depth) less activation HBM)")
    remat_stages = Attr(str,
                        default="stem:conv1+pool1|s2:res2|s3:res3|s4:res4|"
                                "s5:res5|head:pool5+fc1000-conv",
                        help="stage spec for remat=1 (default: resnet "
                             "stages, softmax dropped -> logits loss)")
    train_dropout = Attr(bool, default=False,
                         help="1 = time the training program WITH per-step "
                              "dropout masks (seeded by the chain index), "
                              "as cnet_train runs it; default off keeps "
                              "rows comparable with the r3-r5 tables "
                              "(resnet-50 has no dropout — identical)")

    def main(self):
        import statistics
        import time

        import numpy as np

        from ..backend.xla import enable_compilation_cache
        from ..engine.lower import lower_pipe, resolve_plan_weights
        from ..engine.rtc_fwd import build_fused_forward
        from ..graph.modes import _load_pipe

        enable_compilation_cache()
        pipe = _load_pipe(self)
        op_tunes = pat_tunes(pipe, self.op_tunes_pat) \
            if self.op_tunes_pat else None
        if self.train_dropout and self.remat:
            from ..core.error import RtErr
            raise RtErr("train_bench: train_dropout=1 is not supported "
                        "with remat=1 (the dropout seed is a fed input; "
                        "stage segments take exactly one input)")
        plan = lower_pipe(pipe, self.op_tune, op_tunes=op_tunes,
                          fused_storage=True,
                          train_dropout=self.train_dropout)
        weights = resolve_plan_weights(plan, pipe.op_params)
        data_node = pipe.data_img_node_names[0]
        from_logits = False
        if self.remat:
            from ..engine.segments import build_remat_forward
            fwd = build_remat_forward(plan, weights, self.remat_stages)
            top = fwd.out_node
            softmax_tops = {t for op in pipe.ops.values()
                            if op.type == "Softmax" for t in op.tops}
            from_logits = top not in softmax_tops
        else:
            fwd = build_fused_forward(plan)
            top = ("prob" if "prob" in plan.output_nodes
                   else plan.output_nodes[-1])
        d = pipe.get_data_img_dims()
        rng = np.random.RandomState(0)
        x = (rng.randn(*d.shape) * 0.1).astype(np.float32)

        import jax
        import jax.numpy as jnp

        from ..engine.lower import DROP_SEED_NODE
        from .train import build_train_step, check_labels, init_opt_state
        seed_node = DROP_SEED_NODE \
            if DROP_SEED_NODE in plan.input_nodes else ""
        step = build_train_step(fwd, data_node, top, lr=self.lr,
                                optimizer=self.optimizer,
                                momentum=self.momentum,
                                weight_decay=self.weight_decay,
                                from_logits=from_logits,
                                seed_node=seed_node)

        def chained(w, vel, xb, labels, n):
            def body(_i, carry):
                wc, vc, acc = carry
                loss, w2, v2 = step(wc, vc, xb, labels, None,
                                    _i if seed_node else None)
                return w2, v2, acc + loss
            wf, _vf, acc = jax.lax.fori_loop(
                0, n, body, (w, vel, jnp.float32(0)))
            # read back a scalar that depends on EVERY final weight so no
            # update pass can be dead-coded (whole-output-sum rule)
            tot = acc
            for v in jax.tree_util.tree_leaves(wf):
                tot = tot + v.sum().astype(jnp.float32)
            return tot

        n_classes = plan.node_dims[top].shape[1]
        labels = rng.randint(0, n_classes, size=(d["img"],)).astype(np.int32)
        check_labels(labels, n_classes, "train_bench")

        fn = jax.jit(chained, compiler_options=self.compiler_options or None)
        dev = jax.devices()[0]
        w_dev = {k: jax.device_put(v, dev) for k, v in weights.items()}
        # SGD state is an empty pytree — no weight-sized copies in HBM
        vel_dev = jax.tree_util.tree_map(
            lambda v: jax.device_put(v, dev),
            init_opt_state(self.optimizer, weights))
        x_dev = jax.device_put(x, dev)
        l_dev = jax.device_put(labels, dev)
        iters = max(self.iters, 3)
        n1 = min(max(2, iters // 5), iters - 1)
        t0 = time.perf_counter()
        v1 = float(fn(w_dev, vel_dev, x_dev, l_dev, 1))
        compile_s = time.perf_counter() - t0
        if not np.isfinite(v1):
            from ..core.error import RtErr
            raise RtErr(f"train_bench: non-finite readback {v1}")
        float(fn(w_dev, vel_dev, x_dev, l_dev, n1))
        float(fn(w_dev, vel_dev, x_dev, l_dev, iters))
        slopes = []
        for _ in range(self.reps):
            a = time.perf_counter()
            float(fn(w_dev, vel_dev, x_dev, l_dev, n1))
            b = time.perf_counter()
            float(fn(w_dev, vel_dev, x_dev, l_dev, iters))
            c = time.perf_counter()
            slopes.append(((c - b) - (b - a)) / (iters - n1))
        secs = statistics.median(slopes)

        # prec=bf16: bf16 convs via the mxu_conv custom VJP; prec
        # unset: true f32 (mxu_conv passes explicit HIGHEST precision —
        # a jax.default_matmul_precision context would NOT override it)
        prec = self.op_tune.prec or "f32"
        fl, _ = pipe.total_flops_and_bytes()
        tfl = 3 * fl  # fwd + input-grad + weight-grad passes
        name = self.model or self.ptt_fn
        print(f"train_bench {name} b{d['img']} {prec} "
              f"storage={'nhwc' if plan.storage_nhwc else 'nchw'} "
              f"opt={self.optimizer} lr={self.lr}"
              f"{' remat=1' if self.remat else ''}: "
              f"step_ms={secs * 1e3:.2f} "
              f"imgs_per_sec={d['img'] / secs:.1f} "
              f"tflops={tfl / secs / 1e12:.1f} (3x-fwd est) "
              f"frac_roofline={frac_roofline(tfl / secs, dev, prec)} "
              f"compile_s={compile_s:.1f} device={dev.device_kind}")
