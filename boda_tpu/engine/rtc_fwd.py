"""The generated-kernel network executor: rtc_fwd.cc's JAX analog.

Capability parity with conv_pipe_fwd_t (rtc_fwd.cc:43-577):

  * init: variant annotation + ReLU fusion + topo lowering to a flat call
    plan; weights uploaded once (rtc_fwd.cc:524),
  * run_fwd: copy-in → run calls → sync → copy-out, with per-call event
    timing dump (per_call_fn, rtc_fwd.cc:560-572),
  * per-layer quantization hooks (quantize_ops, rtc_fwd.cc:28-37),
  * per-layer stats dump (enable_stats → var_stats calls, rtc_fwd.cc:105),
  * deterministic-dropout control (set_det_drop_seed, rtc_fwd.cc:91-99).

Addition: `fuse=1` (default) compiles the ENTIRE lowered program
into one jitted XLA function — the reference's 100s of per-op kernel
launches (23µs each, BASELINE.md) collapse into a single dispatch, which is
where this build departs from the reference's execution model. `fuse=0` keeps
reference-style per-call dispatch through the Backend for per-layer timing
and the tuner.
"""

from __future__ import annotations

import time
from typing import Optional

from ..backend.iface import Backend, RtcFuncCall
from ..core.config import Attr, register
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.timers import timer
from ..graph.pipe import ConvPipe
from ..ops.cnn_variants import OpTune
from ..ops.op_base import OpBase
from ..ops.registry import Codegen, get_template
from .iface import ConvFwd
from .lower import Plan, Step, lower_pipe


def _storage_in(v, plan: Plan):
    """Logical (NCHW, node-dtype) input -> fused-program storage form."""
    import jax.numpy as jnp
    if not plan.storage_nhwc or getattr(v, "ndim", 0) != 4:
        return v
    if plan.edge_prec == "bf16" and jnp.issubdtype(v.dtype, jnp.floating):
        v = v.astype(jnp.bfloat16)
    return jnp.transpose(v, (0, 2, 3, 1))


def _storage_out(v, dims, plan: Plan):
    """Fused-program storage tensor -> logical (NCHW, node-dtype) output."""
    import jax.numpy as jnp
    if plan.storage_nhwc and getattr(v, "ndim", 0) == 4:
        v = jnp.transpose(v, (0, 3, 1, 2))
    return v.astype(dims.dtype)


def _storage_zeros(dims, plan: Plan):
    import jax.numpy as jnp
    shape, dt = dims.shape, dims.dtype
    if plan.storage_nhwc and len(shape) == 4:
        shape = (shape[0], shape[2], shape[3], shape[1])
        if plan.edge_prec == "bf16":
            dt = jnp.bfloat16
    return jnp.zeros(shape, dt)


def build_fused_forward(plan: Plan, keep_all_nodes: bool = False,
                        extra_out_nodes=(), write_hook=None):
    """Build the pure whole-net function fwd(inputs: dict, weights: dict) ->
    outputs dict from a lowered Plan. Standalone (no engine/backend) so it
    can be jitted/grad-ed/sharded directly (graft entry, multi-chip dryrun,
    training-step composition).

    Inputs/outputs are always LOGICAL (NCHW, node dtype); when the plan's
    fused-storage pass is active (plan.storage_nhwc) the conversions happen
    once at the program boundary and every interior edge is NHWC/edge_prec.

    `extra_out_nodes`: additional nodes returned alongside output_nodes.
    `write_hook(node, val, aux)`: called on every step write (the engine's
    var-stats capture); when given, fwd returns (outputs, aux) instead."""
    fns = []
    for s in plan.steps:
        tmpl = get_template(s.sig.func_name)
        rfs = tmpl.check_args(s.sig)
        fns.append((tmpl.build(rfs), tmpl, s))
    out_nodes = list(plan.output_nodes) + [n for n in extra_out_nodes
                                           if n not in plan.output_nodes]
    node_dims = plan.node_dims
    weight_set = set(plan.weight_nodes)

    def fwd(inputs: dict, weights: dict):
        vals = dict(weights)
        for n, v in inputs.items():
            # validate feeds up front: a wrong-shaped input otherwise
            # surfaces as an inscrutable shape error deep inside the
            # fused program (e.g. a concat mismatch in the s2d stem)
            nd = node_dims.get(n)
            if nd is None:
                raise RtErr(f"build_fused_forward: unknown input node "
                            f"'{n}' (plan inputs: {plan.input_nodes})")
            got = tuple(getattr(v, "shape", ()))
            if got and got != tuple(nd.shape):
                raise RtErr(f"build_fused_forward: input '{n}' shape "
                            f"{got} != the plan's logical dims "
                            f"{tuple(nd.shape)} ({nd})")
            vals[n] = _storage_in(v, plan)
        aux: dict = {}
        for fn, tmpl, s in fns:
            ins = []
            for an in tmpl.in_args() + tmpl.io_args():
                if an in s.arg_nodes:
                    node = s.arg_nodes[an]
                    if node not in vals:  # INOUT target first touch
                        if node in weight_set:
                            # zero-filling a missing WEIGHT is silently
                            # wrong numerics (the caller resolved weights
                            # for a different plan — e.g. a float-plan
                            # dict fed to a prequantized-int8 plan)
                            raise RtErr(
                                f"build_fused_forward: weight node "
                                f"'{node}' missing from the weights dict "
                                f"(resolve_plan_weights on THIS plan)")
                        vals[node] = _storage_zeros(node_dims[node], plan)
                    ins.append(vals[node])
            outs = fn(*ins)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for an, ov in zip(tmpl.out_args() + tmpl.io_args(), outs):
                if an in s.arg_nodes:
                    vals[s.arg_nodes[an]] = ov
                    if write_hook is not None:
                        write_hook(s.arg_nodes[an], ov, aux)
        if keep_all_nodes:
            ret = {n: _storage_out(v, node_dims[n], plan)
                   for n, v in vals.items()
                   if n not in weights and n not in inputs and n in node_dims}
        else:
            ret = {n: _storage_out(vals[n], node_dims[n], plan)
                   for n in out_nodes if n in vals}
        return (ret, aux) if write_hook is not None else ret

    return fwd


@register(ConvFwd, "rtc", help="Pallas/XLA generated-kernel executor")
class RtcFwd(ConvFwd):
    rtc = Attr(Backend, default="xla", help="backend to run kernels on")
    op_tune = Attr(OpTune, default="()", help="default tuning record")
    fuse = Attr(bool, default=True, help="compile whole net into one XLA program")
    enable_stats = Attr(bool, default=False, help="emit per-layer var stats")
    quantize = Attr(list[str], default=None,
                    help="per-layer quantize specs: (name=...,max_val=...,keep_bits=...)")
    show_rtc_calls = Attr(bool, default=False, help="print per-call info")
    per_call_fn = Attr(str, default="", help="write per-call timing report here")
    write_op_sigs_fn = Attr(str, default="", help="log full op sigs to this file")
    det_drop_seed = Attr(int, default=0, help="deterministic dropout seed")
    force_zero_bias = Attr(bool, default=False,
                           help="zero every bias blob at init (debug "
                                "determinism hook; reference rtc_fwd.cc:59)")
    train_dropout = Attr(bool, default=False, help="apply dropout masks (train mode)")
    keep_all_nodes = Attr(bool, default=False,
                          help="fused mode: keep every intermediate node "
                               "fetchable (for digest comparison; disables DCE)")
    nan_check = Attr(bool, default=False,
                     help="sanitizer: flag non-finite values (NaN/Inf) in "
                          "every float node each forward; raises naming the "
                          "first offending node in step order. Fused mode "
                          "computes the flags device-side (fused reductions, "
                          "no extra readback of the activations)")
    mesh_dp = Attr(int, default=0,
                   help="data-parallel mesh size: shard the batch (img dim) "
                        "over this many devices (0 = single device)")
    mesh_mp = Attr(int, default=1,
                   help="model-parallel mesh size: shard conv/fc out_chans "
                        "over this many devices")
    wisdom_fn = Attr(str, default="",
                     help="wisdom file: per-op best tunes (from ops_prof) "
                          "override the default op_tune on matching sigs")
    op_tunes_pat = Attr(dict[str, str], default=None,
                        help="per-op tune overrides by TAG REGEX, e.g. "
                             "(res3.*_branch2b=(use_culibs=1,prec=bf16,"
                             "layout=nhwc,quant8=1)) — runs the selective-"
                             "precision presets through any engine mode "
                             "(run_cnet, test_lmdb, serving)")
    act_scales_fn = Attr(str, default="",
                         help="calibrated static int8 activation scales "
                              "(tune/presets save_act_scales output) "
                              "applied onto the per-op tunes")

    def init(self, pipe: ConvPipe) -> None:
        self.pipe = pipe
        self.rtc.ensure_init()
        self.codegen = Codegen(self.rtc)
        self._info_log: list[str] = []
        with timer("rtc_fwd_init"):
            op_tunes = self._wisdom_tunes(pipe) if self.wisdom_fn else None
            if self.op_tunes_pat:
                import re

                from ..ops.cnn_variants import make_op_tune
                pats = {}
                for pat, spec in self.op_tunes_pat.items():
                    rx = re.compile(pat)
                    t = make_op_tune(spec)
                    for op in pipe.ops.values():
                        if rx.fullmatch(op.tag):
                            pats[op.tag] = t
                self._info_log.append(
                    f"op_tunes_pat: tuned {len(pats)} op(s)")
                op_tunes = {**(op_tunes or {}), **pats} or None
            if self.act_scales_fn:
                if not op_tunes:
                    raise RtErr("act_scales_fn requires per-op tunes "
                                "(op_tunes_pat or wisdom_fn) naming the "
                                "quant8 sites the scales apply to")
                from ..tune.presets import load_act_scales
                op_tunes = load_act_scales(self.act_scales_fn, op_tunes)
            self.plan = lower_pipe(pipe, self.op_tune, op_tunes=op_tunes,
                                   fuse_relu=True,
                                   train_dropout=self.train_dropout,
                                   fused_storage=self.fuse)
            self._apply_quantize_hooks()
            self._apply_det_drop_seed()
            if self.write_op_sigs_fn:
                with open(self.write_op_sigs_fn, "w") as f:
                    for s in self.plan.steps:
                        f.write(str(s.sig.to_lexp()) + "\n")
            if self.fuse:
                self._init_fused()
            else:
                self._init_per_call()
        self.stats: dict[str, NDA] = {}

    def _wisdom_tunes(self, pipe: ConvPipe):
        """wisdom file → per-op-tag tune overrides (best tune recorded for
        this backend's platform tag; falls back to best-any-platform)."""
        from ..ops.cnn_variants import make_op_tune
        from ..tune.wisdom import load_tune_index, lookup_tune
        plat = self.rtc.get_plat_tag()
        idx = load_tune_index(self.wisdom_fn, plat)
        idx_any = load_tune_index(self.wisdom_fn, "")
        out = {}
        for op in pipe.ops.values():
            ts = lookup_tune(idx, op) or lookup_tune(idx_any, op)
            if ts is not None:
                out[op.tag] = make_op_tune(ts)
        if out:
            self._info_log.append(
                f"wisdom: tuned {len(out)} op(s) from {self.wisdom_fn}")
        return out or None

    # ---- quantize / dropout hooks ----
    def _apply_quantize_hooks(self) -> None:
        if not self.quantize:
            return
        from ..core.lexp import parse_lexp
        new_steps = []
        specs = []
        for q in self.quantize:
            l = parse_lexp(q) if isinstance(q, str) else q
            kid = l.get_kid("name")
            l.deep_inc_use_cnt()
            if kid is None:
                raise RtErr(f"quantize spec missing 'name': {q}")
            specs.append({
                "name": kid.leaf_val,
                "max_val": float(l.get_kid("max_val").leaf_val) if l.get_kid("max_val") else 1.0,
                "keep_bits": int(l.get_kid("keep_bits").leaf_val) if l.get_kid("keep_bits") else 8,
                "matched": False,
            })
        for s in self.plan.steps:
            new_steps.append(s)
            tmpl = get_template(s.sig.func_name)
            write_args = tmpl.out_args() + tmpl.io_args()
            for sp in specs:
                # insert a quantize call right after any step that writes the
                # named node (reference: gen_op_quantize after producer) —
                # match the TEMPLATE's declared write args, so fused-sibling
                # outs (out_a..), loss, and grads all count
                writes = any(s.arg_nodes.get(a) == sp["name"]
                             for a in write_args)
                if writes:
                    sp["matched"] = True
                    dims = self.plan.node_dims[sp["name"]]
                    qsig = OpBase({"type": "quantize", "func_name": "quantize"})
                    qsig.set_dims("inout", dims)
                    qsig.nda_vals["max_val"] = NDA.scalar(sp["max_val"], "float")
                    qsig.set_u32("keep_bits", sp["keep_bits"])
                    new_steps.append(Step(qsig, {"inout": sp["name"]},
                                          f"quantize__{sp['name']}"))
        unmatched = [sp["name"] for sp in specs if not sp["matched"]]
        if unmatched:
            # a typo'd node name silently measuring nothing is the worst
            # outcome for an accuracy study (reference errored on unknown
            # vars)
            raise RtErr(f"quantize: no step writes node(s) {unmatched}")
        self.plan.steps = new_steps

    def _apply_det_drop_seed(self) -> None:
        if not self.det_drop_seed:
            return
        for s in self.plan.steps:
            if s.sig.func_name == "dropout":
                s.sig.set_u32("det_drop_seed", self.det_drop_seed)

    # ---- per-call mode (reference-style) ----
    def _init_per_call(self) -> None:
        be = self.rtc
        for name, dims in self.plan.node_dims.items():
            if not be.var_exists(name):
                be.create_var_with_dims(name, dims)
        self.fwd_calls: list[RtcFuncCall] = []
        for s in self.plan.steps:
            inst = self.codegen.gen_func(s.sig)
            self.fwd_calls.append(RtcFuncCall(inst, dict(s.arg_nodes), s.call_tag))
        if self.enable_stats:
            self._add_stats_calls()
        self.codegen.compile_pend()
        # resolved = raw op_params + prequantized int8 weights/scales; the
        # original float weight vars of rewritten sites stay allocated but
        # unread (node_dims keeps every node)
        from .lower import resolve_plan_weights
        import numpy as np
        resolved = resolve_plan_weights(self.plan, self.pipe.op_params)
        params = {n: NDA(self.plan.node_dims[n], v)
                  for n, v in resolved.items()}
        if self.force_zero_bias:
            params = {n: (NDA(v.dims, np.zeros(v.dims.shape, v.v.dtype))
                          if n.endswith("biases") else v)
                      for n, v in params.items()}
        be.copy_ndas_to_vars(params)

    def _add_stats_calls(self) -> None:
        seen = set()
        extra = []
        for call, s in zip(list(self.fwd_calls), self.plan.steps):
            writes = set(get_template(s.sig.func_name).out_args()
                         + get_template(s.sig.func_name).io_args())
            for a, node in s.arg_nodes.items():
                if a in writes and node not in seen:
                    seen.add(node)
                    sig = OpBase({"type": "var_stats", "func_name": "var_stats"})
                    sig.set_dims("in", self.plan.node_dims[node])
                    inst = self.codegen.gen_func(sig)
                    sname = f"{node}__stats"
                    if not self.rtc.var_exists(sname):
                        self.rtc.create_var_with_dims(sname, Dims.make(n=4))
                    extra.append((call, RtcFuncCall(inst, {"in": node, "stats": sname},
                                                    f"stats__{node}")))
        # interleave stats calls right after their producing call
        out = []
        for c in self.fwd_calls:
            out.append(c)
            out += [sc for (pc, sc) in extra if pc is c]
        self.fwd_calls = out

    # ---- fused mode (one XLA program) ----
    def _init_fused(self) -> None:
        import jax
        weight_nodes = [n for n in self.plan.weight_nodes]
        if not hasattr(self, "_extra_out_nodes"):
            self._extra_out_nodes: list[str] = []
        stats_fns = {}
        write_hook = None
        if self.enable_stats:
            stats_nodes = sorted({
                node for s in self.plan.steps
                for a, node in s.arg_nodes.items()
                if a in (get_template(s.sig.func_name).out_args()
                         + get_template(s.sig.func_name).io_args())})
            for node in stats_nodes:
                sig = OpBase({"type": "var_stats", "func_name": "var_stats"})
                sig.set_dims("in", self.plan.node_dims[node])
                t = get_template("var_stats")
                stats_fns[node] = t.build(t.check_args(sig))

            def write_hook(node, ov, aux):
                if node in stats_fns:
                    aux[node] = stats_fns[node](ov)

        self._nan_node_order: list[str] = []
        if self.nan_check:
            import jax.numpy as jnp
            stats_hook = write_hook

            def write_hook(node, ov, aux, _sh=stats_hook):
                if _sh is not None:
                    _sh(node, ov, aux)
                key = ("__nonfinite__", node)
                if (jnp.issubdtype(ov.dtype, jnp.floating)
                        and key not in aux):
                    if node not in self._nan_node_order:
                        self._nan_node_order.append(node)
                    aux[key] = ~jnp.all(jnp.isfinite(ov))

        # one executor core: the engine reuses build_fused_forward (extras
        # + per-write stats hook) instead of duplicating its loop
        fwd0 = build_fused_forward(self.plan,
                                   keep_all_nodes=self.keep_all_nodes,
                                   extra_out_nodes=tuple(self._extra_out_nodes),
                                   write_hook=write_hook)
        fwd = fwd0 if write_hook is not None else \
            (lambda inputs, weights: (fwd0(inputs, weights), {}))

        if getattr(self, "_input_preproc", None):
            # device-side input preprocessing composes INSIDE the jit:
            # e.g. the u8 serving wire format's decode/mean-subtract/
            # transpose fuses with the net forward — one dispatch, and the
            # host uploads the raw u8 bytes (4x smaller than f32)
            pre = dict(self._input_preproc)
            fwd_core = fwd

            def fwd(inputs, weights, _core=fwd_core, _pre=pre):
                inputs = {**inputs, **{n: f(inputs[n])
                                       for n, f in _pre.items()
                                       if n in inputs}}
                return _core(inputs, weights)

        self._fused_fn = jax.jit(fwd)
        # raw op_params plus the prequantization pass's derived int8
        # weights/scales (weight quant runs ONCE here, not per forward)
        from .lower import resolve_plan_weights
        self._weights = resolve_plan_weights(self.plan, self.pipe.op_params)
        if self.force_zero_bias:
            import numpy as np
            self._weights = {n: (np.zeros_like(v) if n.endswith("biases")
                                 else v) for n, v in self._weights.items()}
        # mesh execution: commit weights with named shardings; jit follows
        # committed input shardings, GSPMD inserts the ICI collectives
        self._mesh = None
        self._in_sh = None
        if not self.mesh_dp:
            # commit weights to device ONCE: jit re-streams numpy args
            # EVERY call (~100MB per batch for resnet-50). Committed jax
            # Arrays stay on the device, so steady-state dispatch pays
            # only the input upload.
            import jax
            self._weights = jax.device_put(self._weights)
        if self.mesh_dp:
            from ..parallel.mesh import make_mesh, plan_shardings
            self._mesh = make_mesh(n_devices=self.mesh_dp * self.mesh_mp,
                                   dp=self.mesh_dp, mp=self.mesh_mp)
            self._in_sh, w_sh = plan_shardings(self.plan, self._mesh,
                                               shard_weights=self.mesh_mp > 1)
            self._weights = {n: jax.device_put(v, w_sh[n])
                             for n, v in self._weights.items()}
        self._fused_compiled = False

    def set_input_preproc(self, node: str, fn) -> None:
        """Compose a traceable device-side transform onto input `node`
        inside the fused program (the serving counterpart of the
        host-side subtract_mean_and_copy_img_to_batch, caffeif.H:13: the
        transform fuses with the forward under ONE jit)."""
        if not self.fuse:
            raise RtErr("set_input_preproc requires the fused engine "
                        "(fuse=1)")
        if not hasattr(self, "_input_preproc"):
            self._input_preproc: dict = {}
        self._input_preproc[node] = fn
        self._init_fused()

    # ---- run ----
    def run_fwd(self, to_set: dict[str, NDA], to_get: list[str]) -> dict[str, NDA]:
        if self.fuse:
            return self._run_fused(to_set, to_get)
        return self._run_per_call(to_set, to_get)

    def _run_fused(self, to_set: dict[str, NDA], to_get: list[str]) -> dict[str, NDA]:
        import numpy as np
        # requested intermediates become program outputs (reference run_fwd
        # copies out any named var, rtc_fwd.cc:555) — re-jit once to add
        # them. Weight nodes are served from self._weights directly (they
        # are stored NCHW and must NOT pass the storage-out transpose);
        # keep_all_nodes already returns every intermediate, so no re-jit.
        weight_gets = {n for n in to_get if n in self.plan.weight_nodes}
        if not self.keep_all_nodes:
            produced = {node for s in self.plan.steps
                        for a, node in s.arg_nodes.items()
                        if a in (get_template(s.sig.func_name).out_args()
                                 + get_template(s.sig.func_name).io_args())}
            produced |= set(self.plan.input_nodes)  # fed, hence fetchable
            want_extra = [n for n in to_get
                          if n not in self.plan.output_nodes
                          and n not in self._extra_out_nodes
                          and n not in weight_gets
                          and n in self.plan.node_dims]
            bad = [n for n in want_extra if n not in produced]
            if bad:
                # don't pay a whole-net recompile to then fail: nodes
                # eliminated by fusion (resblock/stem/sibling interiors)
                # are not fetchable
                raise RtErr(f"run_fwd: node(s) {bad} are not produced by "
                            f"any step (eliminated by fusion?)")
            if want_extra:
                self._extra_out_nodes += want_extra
                self._init_fused()
        with timer("run_fwd"):
            inputs = {k: v.v for k, v in to_set.items()}
            import jax
            if self._in_sh is not None:
                inputs = {k: jax.device_put(v, self._in_sh[k])
                          if k in self._in_sh else v
                          for k, v in inputs.items()}
            else:
                # explicit device_put (not jit's numpy-arg conversion):
                # one upload per input, committed to this device
                inputs = jax.device_put(inputs)
            t0 = time.perf_counter()
            outs, stats = self._fused_fn(inputs, self._weights)
            outs = {k: np.asarray(v) for k, v in outs.items()}
            self.last_run_secs = time.perf_counter() - t0
        if self.nan_check:
            bad = [n for n in self._nan_node_order
                   if bool(stats.get(("__nonfinite__", n), False))]
            stats = {k: v for k, v in stats.items()
                     if not (isinstance(k, tuple) and k[0] == "__nonfinite__")}
            if bad:
                raise RtErr(f"nan_check: non-finite values in node(s) "
                            f"{bad} (first in step order: '{bad[0]}')")
        if self.enable_stats:
            self.stats = {k: NDA(Dims.make(n=4), np.asarray(v)) for k, v in stats.items()}
        for n in weight_gets:
            outs[n] = np.asarray(self._weights[n])
        missing = [n for n in to_get if n not in outs]
        if missing:
            raise RtErr(f"run_fwd: requested nodes not produced: {missing} "
                        f"(outputs: {sorted(outs)})")
        return {n: NDA(self.plan.node_dims[n], outs[n]) for n in to_get}

    def _run_per_call(self, to_set: dict[str, NDA], to_get: list[str]) -> dict[str, NDA]:
        be = self.rtc
        with timer("run_fwd"):
            be.copy_ndas_to_vars(to_set)
            call_ids = []
            for c in self.fwd_calls:
                if self.show_rtc_calls:
                    self._info_log.append(f"CALL {c.call_tag} {c.func_name} {c.args}")
                call_ids.append(self.codegen.run_func(c))
            be.finish_and_sync()
            if call_ids:
                self.last_run_secs = be.get_dur(call_ids[0], call_ids[-1])
        if self.per_call_fn:
            with open(self.per_call_fn, "w") as f:
                f.write("per-layer timing (tag func secs):\n")
                for c, cid in zip(self.fwd_calls, call_ids):
                    f.write(f"{c.call_tag} {c.func_name} "
                            f"{be.get_dur(cid, cid):.9f}\n")
        if self.nan_check:
            import numpy as np
            seen: set = set()
            for s in self.plan.steps:
                writes = set(get_template(s.sig.func_name).out_args()
                             + get_template(s.sig.func_name).io_args())
                for a, node in s.arg_nodes.items():
                    if a in writes and node not in seen:
                        seen.add(node)
                        v = be.copy_var_to_nda(node).v
                        if v.dtype.kind == "f" and not np.isfinite(v).all():
                            raise RtErr(f"nan_check: non-finite values in "
                                        f"node '{node}' (first in step order)")
        if self.enable_stats:
            for n in be.var_names():
                if n.endswith("__stats"):
                    self.stats[n[:-7]] = be.copy_var_to_nda(n)
        return be.copy_vars_to_ndas(to_get)

    def get_info_log(self) -> str:
        return "\n".join(self._info_log)
