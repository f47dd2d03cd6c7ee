"""cnet_xprof: per-kernel device-event timing via the XLA/PJRT profiler.

Reference parity: per-call device event timing — `rtc_compute_t::get_dur`
over CUDA events (reference `src/nvrtc_util.cc:296`, `src/rtc_prof.cc:37`)
feeding boda's per-kernel tables. Here the per-kernel analog is the xplane
trace: collect a `jax.profiler.trace` around N forwards of the fused net
and aggregate per-HLO-op device durations from the serialized xspace
(`jax.profiler.ProfileData`). Slope timing measures ONE number per
program; this decomposes it per kernel, per call.

On a GPU the `/device:GPU:N` planes carry one line per CUDA stream, whose
events are the kernels, each tagged with the `hlo_op` (and `hlo_module`)
stat of the HLO instruction that launched it. The CPU backend has no
device plane: its events sit on the host plane's PJRT client lines with
the same `hlo_op` stat. Events are matched by that stat, so host-side
python/runtime events never pollute the table.
"""

from __future__ import annotations

import re
from pathlib import Path

from ..core.config import Attr
from ..core.error import RtErr
from ..core.has_main import mode

_TRAIL_ID = re.compile(r"\.\d+$")


def find_xplane(trace_dir: str | Path) -> Path:
    """Newest .xplane.pb under trace_dir (jax writes plugins/profile/<ts>/)."""
    cands = sorted(Path(trace_dir).rglob("*.xplane.pb"),
                   key=lambda p: p.stat().st_mtime)
    if not cands:
        raise RtErr(f"no .xplane.pb found under {trace_dir}")
    return cands[-1]


def aggregate_xplane(xplane_fn: str | Path, platform: str = "cpu"):
    """Parse a serialized xspace; return (rows, meta).

    rows: [{op, kind, module, count, total_ns}] aggregated over calls,
    kind = op name stripped of its trailing `.N` instance id.
    meta: {planes: [...], device_planes: [...], busy_ns, window_ns}:
    busy_ns is the union of the device kernel intervals and window_ns the
    span from the first kernel start to the last kernel end (device idle
    share = 1 - busy/window). On `gpu` a trace without device kernel events
    is an error, never a silent fall back to host-side events.
    """
    from jax.profiler import ProfileData

    p = ProfileData.from_file(str(xplane_fn))
    agg: dict[str, dict] = {}
    spans: list[tuple[int, int]] = []

    def add(hlo: str, module: str, dur_ns: float, text: str = ""):
        r = agg.get(hlo)
        if r is None:
            r = agg[hlo] = {"op": hlo, "kind": _TRAIL_ID.sub("", hlo),
                            "module": module, "count": 0, "total_ns": 0.0,
                            "text": text}
        r["count"] += 1
        r["total_ns"] += dur_ns

    planes = [pl.name for pl in p.planes]
    dev_planes = []
    for pl in p.planes:
        if not pl.name.startswith("/device:"):
            continue
        seen = False
        for ln in pl.lines:
            for ev in ln.events:
                st = dict(ev.stats)
                hlo = st.get("hlo_op")
                if not hlo:
                    continue
                seen = True
                add(hlo, st.get("hlo_module", ""), float(ev.duration_ns),
                    ev.name)
                spans.append((int(ev.start_ns),
                              int(ev.start_ns + ev.duration_ns)))
        if seen:
            dev_planes.append(pl.name)
    if not agg:
        if platform != "cpu":
            raise RtErr(f"no device kernel events (hlo_op) in the "
                        f"{platform} trace {xplane_fn}; planes: {planes}")
        # CPU backend: hlo_op-stat events on the host plane
        for pl in p.planes:
            for ln in pl.lines:
                for ev in ln.events:
                    st = dict(ev.stats)
                    hlo = st.get("hlo_op")
                    if not hlo or ev.name.startswith("end:"):
                        continue
                    add(hlo, st.get("hlo_module", ""),
                        float(ev.duration_ns))
    busy = 0
    end = None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (max(e for _s, e in spans) - min(s for s, _e in spans)
              if spans else 0)
    rows = sorted(agg.values(), key=lambda r: -r["total_ns"])
    return rows, {"planes": planes, "device_planes": dev_planes,
                  "busy_ns": busy, "window_ns": window}


def rollup_kinds(rows):
    """Aggregate per-op rows by kind (instance-id-stripped name)."""
    by_kind: dict[str, dict] = {}
    for r in rows:
        k = by_kind.setdefault(r["kind"],
                               {"kind": r["kind"], "count": 0,
                                "total_ns": 0.0, "n_ops": 0})
        k["count"] += r["count"]
        k["total_ns"] += r["total_ns"]
        k["n_ops"] += 1
    return sorted(by_kind.values(), key=lambda r: -r["total_ns"])


from ..apps.cnet_bench import CnetBench  # noqa: E402  (attr/tune reuse)


@mode("cnet_xprof", help="per-kernel device-event profile (xplane trace)")
class CnetXprof(CnetBench):
    """Trace `steps` forwards of the fused net under jax.profiler and
    report per-HLO-op device time. Inherits every net/tune attr from
    cnet_bench so the profiled program is byte-identical to the benched
    one. `iters`/`reps` are unused here (trace replaces slope timing)."""

    steps = Attr(int, default=10, help="forwards to run inside the trace")
    bwd = Attr(bool, default=False,
               help="profile the TRAINING step instead: grad of a "
                    "logits-sum loss w.r.t. all weights (the same "
                    "construction as cnet_stage_probe --bwd) — decomposes "
                    "the whole-net backward per kernel")
    top_k = Attr(int, default=25, help="rows in the per-op table")
    dump_fn = Attr(str, default="",
                   help="also write every row with its full HLO "
                        "instruction text (shape provenance) to this file")
    trace_dir = Attr(str, default="",
                     help="keep the raw xplane trace here (e.g. for "
                          "TensorBoard); default: temp dir, deleted")

    def main(self):
        import tempfile
        import time

        import jax

        pipe, plan, fwd, weights, x = self._build_fused()
        d = pipe.get_data_img_dims()
        data_node = pipe.data_img_node_names[0]
        top = "prob" if "prob" in plan.output_nodes else plan.output_nodes[-1]

        dev = jax.devices()[0]
        w_dev = {k: jax.device_put(v, dev) for k, v in weights.items()}
        x_dev = jax.device_put(x, dev)

        if self.bwd:
            import jax.numpy as jnp

            from ..engine.rtc_fwd import build_fused_forward

            # backprop from the pre-softmax logits, exactly as
            # cnet_stage_probe --bwd / cnet_train do (softmax VJP of an
            # all-ones cotangent is ~0); surface the logits node via
            # extra_out_nodes so whole-net fusion survives
            top_op = next((op for op in pipe.ops.values()
                           if top in op.tops), None)
            if top_op is not None and top_op.type == "Softmax":
                top = top_op.bots[0]
            bfwd = build_fused_forward(
                plan, extra_out_nodes=(top,)
                if top not in plan.output_nodes else ())

            def net_loss(w, xb):
                return bfwd({data_node: xb}, w)[top] \
                    .ravel().astype(jnp.float32).sum()

            ngrad = jax.grad(net_loss)

            def step(w, xb):
                g = ngrad(w, xb)
                tot = jnp.float32(0)
                for v in jax.tree_util.tree_leaves(g):
                    tot = tot + v.ravel().astype(jnp.float32).sum()
                return tot
        else:
            def step(w, xb):
                return fwd({data_node: xb}, w)[top].sum()

        fn = jax.jit(step, compiler_options=self.compiler_options or None)
        t0 = time.perf_counter()
        fn(w_dev, x_dev).block_until_ready()  # compile outside the trace
        compile_s = time.perf_counter() - t0

        tmp = None
        if self.trace_dir:
            tdir = Path(self.trace_dir)
            tdir.mkdir(parents=True, exist_ok=True)
        else:
            tmp = tempfile.TemporaryDirectory(prefix="boda_xprof_")
            tdir = Path(tmp.name)
        with jax.profiler.trace(str(tdir)):
            acc = None
            for _ in range(self.steps):
                acc = fn(w_dev, x_dev)
            acc.block_until_ready()

        rows, meta = aggregate_xplane(find_xplane(tdir), dev.platform)
        if tmp is not None:
            tmp.cleanup()
        if self.dump_fn:
            p = self.out_path(self.dump_fn)
            with open(p, "w") as f:
                for r in rows:
                    f.write(f"{r['total_ns'] / 1e6 / self.steps:9.4f} ms "
                            f"x{r['count']:<4d} "
                            f"{r.get('text') or r['op']}\n")
            print(f"wrote {len(rows)} rows to {p}")

        total_ns = sum(r["total_ns"] for r in rows)
        name = self.model or self.ptt_fn
        if not rows:
            print(f"cnet_xprof {name}: no hlo_op events in the trace "
                  f"(planes: {meta['planes']})")
            return
        print(f"cnet_xprof {name} b{d['img']} steps={self.steps} "
              f"device={dev.device_kind} compile_s={compile_s:.1f} "
              f"planes={meta['device_planes'] or meta['planes']}")
        print(f"device total: {total_ns / 1e6 / self.steps:.3f} ms/step "
              f"over {len(rows)} hlo ops")
        if meta["window_ns"]:
            print(f"device idle share: "
                  f"{1 - meta['busy_ns'] / meta['window_ns']:.4f} "
                  f"(busy {meta['busy_ns'] / 1e6:.3f} ms of a "
                  f"{meta['window_ns'] / 1e6:.3f} ms kernel window)")
        hdr = f"{'hlo op':44s} {'calls':>6s} {'ms/step':>9s} {'%':>6s}"
        print(hdr)
        for r in rows[:self.top_k]:
            print(f"{r['op'][:44]:44s} {r['count']:6d} "
                  f"{r['total_ns'] / 1e6 / self.steps:9.3f} "
                  f"{100 * r['total_ns'] / max(total_ns, 1):6.2f}")
        print("-- by kind --")
        for r in rollup_kinds(rows)[:self.top_k]:
            print(f"{r['kind'][:44]:44s} {r['count']:6d} "
                  f"{r['total_ns'] / 1e6 / self.steps:9.3f} "
                  f"{100 * r['total_ns'] / max(total_ns, 1):6.2f}")
