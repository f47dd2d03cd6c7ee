#!/usr/bin/env python3
"""GPU smoke check: drive the main paths once on the card, at full width.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py              # one card: phases 1-6 below
    python chip_smoke.py --chips 4    # four cards: the sharded paths only

One card, through the calls the CLI modes make:
  1 forward   ResNet-50 224² b128, shipped tune (bf16, NHWC storage), on
              the trained 40-class weights; checked against the same plan
              in float32 at HIGHEST precision (top-1 agreement on
              held-out images) and the float32 plan against the float64
              `ref` engine on 2 images.
  2 default   the hand-variant path of `run_cnet --op-tune=()` (k1conv,
              ipconv, conv, xla_conv) at b32, against phase 1's float32 plan.
  3 int8      the selective-int8 preset of bench.py on the trained weights
              and calibrated scales, gated like tests/test_quant8.py; the
              compiled program must hold int8 convolutions.
  4 train     SGD steps of the shipped bf16 plan (ops/mxu_grad custom VJP)
              on a fixed batch: the loss stays finite and falls, and one
              step's weight gradients match a float32 HIGHEST jax.grad.
  5 serve     aio_cls_selfcheck: a server and 3 concurrent clients in this
              process; every client gets its top-k answer.
  6 backend   rtc_test names a gpu platform; cnet_xprof traces phase 1's
              program and finds kernel events on the device plane.
Four cards (--chips 4): the dp×mp sharded ResNet-50 forward against one
card, the sharded bf16 training step, and GPipe and 1F1B against their
sequential segments (__graft_entry__.py).

Each phase prints one line with its compile seconds and the device's
peak_bytes_in_use. The run exits non-zero, and prints no result line,
when JAX finds no GPU, when a phase raises, or when a comparison misses
its tolerance. Otherwise the last line of stdout is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
SHIPPED = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)"
F32 = "(use_culibs=1,layout=nhwc,s2d=0,fuse_siblings=1)"
# held-out split of the shapes set the trained weights never saw
# (tests/test_quant8.py: start_ix=100000, seed=1, mean=128, scale=1/64)
HELD_OUT = dict(start_ix=100000, seed=1, mean=128.0, scale=1.0 / 64.0)
NUM_CLASSES = 40

# Tolerances, and why:
# bf16 vs float32 top-1 agreement: bf16 keeps 8 mantissa bits, so only
# images whose top-2 logits are nearly tied may flip; at most 1% may.
TOP1_AGREE = 0.99
# float32 (HIGHEST) vs the float64 ref engine, max relative difference of
# `prob`: the repo's bound for these trained weights
# (tests/test_tpu_digests.py), f32 accumulation drift over 53 convs.
REF_MRD = 3e-3
# int8 preset vs bf16: the gates of tests/test_quant8.py's 64-image run.
INT8_TOP1_AGREE = 0.97
INT8_TOP1_IN_TOP5 = 0.98
# bf16 training gradients vs float32 HIGHEST, relative L2 error over all
# weights: bf16 rounds every stored activation and every cotangent to 2^-9
# relative, and over the ~50 conv layers of the backward chain these
# roundings add up to several 1e-2. A broken gradient rule (a missing or
# transposed term, a wrong layout) is off by order one; 0.1 separates the
# two.
GRAD_REL_L2 = 0.1


class SmokeFail(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFail(msg)


@dataclass(frozen=True)
class Size:
    """Widths of each phase. FULL is what the card runs; tests shrink it."""
    fwd_batch: int = 128
    default_batch: int = 32
    ref_imgs: int = 2
    hw: int = 224
    train_batch: int = 32
    train_hw: int = 224
    train_steps: int = 5
    lr: float = 0.01
    serve_model: str = "resnet-50"
    mesh_batch: int = 8


FULL = Size()


@dataclass
class Ctx:
    size: Size
    platform: str
    vals: dict = field(default_factory=dict)


def peak_bytes() -> str:
    import jax
    st = jax.devices()[0].memory_stats()
    return str(st["peak_bytes_in_use"]) if st else "n/a"


def _held_out(n: int, hw: int):
    from boda_tpu.io.synth import render_shapes
    s = HELD_OUT["start_ix"]
    imgs, labels = render_shapes(range(s, s + n), hw, hw, NUM_CLASSES,
                                 HELD_OUT["seed"])
    x = (imgs.astype(np.float32) - HELD_OUT["mean"]) * HELD_OUT["scale"]
    return x, labels


def _trained_pipe(batch: int, hw: int):
    from boda_tpu.apps.train import load_weights_into_pipe
    from boda_tpu.models.zoo import build_model
    pipe = build_model("resnet-50", batch=batch, ysz=hw, xsz=hw,
                       num_classes=NUM_CLASSES)
    load_weights_into_pipe(pipe, str(DATA / "resnet50-shapes40.boda"))
    return pipe


def _forward(pipe, tune: str, op_tunes=None):
    """lower_pipe → build_fused_forward → jit, compiled ahead of the call:
    returns (compiled fn(w, x) -> prob, device weights)."""
    import jax

    from boda_tpu.engine.lower import lower_pipe, resolve_plan_weights
    from boda_tpu.engine.rtc_fwd import build_fused_forward
    from boda_tpu.ops.cnn_variants import make_op_tune
    plan = lower_pipe(pipe, make_op_tune(tune), op_tunes=op_tunes,
                      fused_storage=True)
    fwd = build_fused_forward(plan)
    w = jax.device_put(resolve_plan_weights(plan, pipe.op_params))
    x = jax.ShapeDtypeStruct(pipe.get_data_img_dims().shape, np.float32)
    f = jax.jit(lambda w, x: fwd({"data": x}, w)["prob"])
    return f.lower(w, x).compile(), w


def _probs(p) -> np.ndarray:
    p = np.asarray(p, np.float64)
    return p.reshape(p.shape[0], -1)


def _mrd(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _top1_agree(a, b) -> float:
    return float((a.argmax(1) == b.argmax(1)).mean())


def phase_forward(ctx: Ctx) -> str:
    import jax

    from boda_tpu.core.dims import NDA
    from boda_tpu.engine.iface import make_engine
    sz = ctx.size
    x, labels = _held_out(sz.fwd_batch, sz.hw)
    pipe = _trained_pipe(sz.fwd_batch, sz.hw)
    f_bf, w_bf = _forward(pipe, SHIPPED)
    p_bf = _probs(f_bf(w_bf, x))
    with jax.default_matmul_precision("highest"):
        f_32, w_32 = _forward(pipe, F32)
    p_32 = _probs(f_32(w_32, x))
    check(np.isfinite(p_bf).all() and np.isfinite(p_32).all(),
          "forward: non-finite prob")
    check(p_bf.shape == (sz.fwd_batch, NUM_CLASSES),
          f"forward: prob shape {p_bf.shape}")
    agree = _top1_agree(p_bf, p_32)
    check(agree >= TOP1_AGREE,
          f"forward: bf16 vs f32 top-1 agreement {agree} < {TOP1_AGREE}")
    n = sz.ref_imgs
    ref_pipe = _trained_pipe(n, sz.hw)
    eng = make_engine("(engine=ref)")
    eng.init(ref_pipe)
    d = ref_pipe.get_data_img_dims()
    p_ref = _probs(eng.run_fwd({"data": NDA(d, x[:n])}, ["prob"])["prob"].v)
    mrd_ref = _mrd(p_32[:n], p_ref)
    check(mrd_ref <= REF_MRD,
          f"forward: f32 vs float64 ref mrd {mrd_ref:.3e} > {REF_MRD}")
    ctx.vals.update(x=x, labels=labels, p_bf=p_bf, p_32=p_32)
    acc = float((p_bf.argmax(1) == labels).mean())
    return (f"b{sz.fwd_batch} {sz.hw}x{sz.hw} bf16-vs-f32 top1_agree={agree}"
            f" prob_mrd={_mrd(p_bf, p_32):.3e} f32-vs-ref{n}"
            f" mrd={mrd_ref:.3e} bf16_top1_acc={acc}")


def phase_default(ctx: Ctx) -> str:
    sz = ctx.size
    check("p_32" in ctx.vals, "default: needs phase 1's float32 outputs")
    n = sz.default_batch
    x = ctx.vals["x"][:n]
    pipe = _trained_pipe(n, sz.hw)
    f, w = _forward(pipe, "()")
    p = _probs(f(w, x))
    want = ctx.vals["p_32"][:n]
    agree = _top1_agree(p, want)
    mrd = _mrd(p, want)
    check(np.isfinite(p).all(), "default: non-finite prob")
    check(agree >= TOP1_AGREE, f"default: top-1 agreement {agree}")
    check(mrd <= REF_MRD, f"default: prob mrd {mrd:.3e} > {REF_MRD}")
    return f"b{n} tune=() top1_agree={agree} prob_mrd={mrd:.3e}"


def phase_int8(ctx: Ctx) -> str:
    from boda_tpu.tune.presets import load_act_scales, resnet_int8_site_tunes
    sz = ctx.size
    check("p_bf" in ctx.vals, "int8: needs phase 1's bf16 outputs")
    pipe = _trained_pipe(sz.fwd_batch, sz.hw)
    op_tunes = resnet_int8_site_tunes(pipe, SHIPPED)
    op_tunes = load_act_scales(
        str(DATA / "resnet50-shapes40-int8-scales.lexp"), op_tunes)
    f, w = _forward(pipe, SHIPPED, op_tunes=op_tunes)
    hlo = f.as_text()
    n_s8 = sum("s8[" in ln and "conv" in ln for ln in hlo.splitlines())
    check(n_s8 > 0, "int8: the compiled program holds no int8 convolution")
    p = _probs(f(w, ctx.vals["x"]))
    ref = ctx.vals["p_bf"]
    agree = _top1_agree(p, ref)
    top5 = np.argsort(-ref, axis=1)[:, :5]
    in5 = float(np.mean([p[i].argmax() in top5[i] for i in range(len(p))]))
    check(np.isfinite(p).all(), "int8: non-finite prob")
    check(agree >= INT8_TOP1_AGREE,
          f"int8: top-1 agreement with bf16 {agree} < {INT8_TOP1_AGREE}")
    check(in5 >= INT8_TOP1_IN_TOP5,
          f"int8: int8 top-1 in bf16 top-5 {in5} < {INT8_TOP1_IN_TOP5}")
    return (f"b{sz.fwd_batch} sites={len(op_tunes)} int8_conv_lines={n_s8}"
            f" top1_agree={agree} top1_in_bf16_top5={in5}")


def phase_train(ctx: Ctx) -> str:
    import jax
    import jax.numpy as jnp

    from boda_tpu.apps.train import build_train_step
    from boda_tpu.engine.lower import lower_pipe, resolve_plan_weights
    from boda_tpu.engine.rtc_fwd import build_fused_forward
    from boda_tpu.ops.cnn_variants import make_op_tune
    sz = ctx.size
    n = sz.train_batch
    x, labels = _held_out(n, sz.train_hw)
    labels = jnp.asarray(labels)
    pipe = _trained_pipe(n, sz.train_hw)
    sm = next(op for op in pipe.ops.values() if op.type == "Softmax")
    logits = sm.bots[0]

    def build(tune):
        plan = lower_pipe(pipe, make_op_tune(tune), fused_storage=True)
        fwd = build_fused_forward(plan, extra_out_nodes=(logits,))
        return fwd, resolve_plan_weights(plan, pipe.op_params)

    def loss_fn(fwd):
        def f(w):
            z = fwd({"data": x}, w)[logits].astype(jnp.float32)
            z = z.reshape(z.shape[0], -1)
            logp = jax.nn.log_softmax(z, axis=1)
            return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))
        return f

    fwd, w0 = build(SHIPPED)
    step = jax.jit(build_train_step(fwd, "data", logits, lr=sz.lr,
                                    from_logits=True))
    w = jax.device_put(w0)
    vel: dict = {}
    losses = []
    for _ in range(sz.train_steps):
        loss, w, vel = step(w, vel, x, labels)
        losses.append(float(loss))
    check(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall {losses}")
    g_bf = jax.jit(jax.grad(loss_fn(fwd)))(jax.device_put(w0))
    with jax.default_matmul_precision("highest"):
        fwd32, w32 = build(F32)
        g_32 = jax.jit(jax.grad(loss_fn(fwd32)))(jax.device_put(w32))
    num = den = 0.0
    worst = (0.0, "")
    for k in g_32:
        a = np.asarray(g_bf[k], np.float64)
        b = np.asarray(g_32[k], np.float64)
        num += float(np.sum((a - b) ** 2))
        den += float(np.sum(b ** 2))
        r = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        worst = max(worst, (r, k))
    rel = (num / max(den, 1e-60)) ** 0.5
    check(rel <= GRAD_REL_L2,
          f"train: bf16 vs f32 grad rel L2 {rel:.3e} > {GRAD_REL_L2}")
    return (f"b{n} {sz.train_hw}x{sz.train_hw} sgd lr={sz.lr} losses="
            f"{[round(v, 5) for v in losses]} grad_rel_l2={rel:.3e}"
            f" worst_tensor={worst[1]}:{worst[0]:.3e}")


def _run_mode(spec: str) -> str:
    from boda_tpu.core.has_main import create_and_run_has_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        create_and_run_has_main(spec, {})
    return buf.getvalue()


def phase_serve(ctx: Ctx) -> str:
    out = _run_mode(f"(mode=aio_cls_selfcheck,model={ctx.size.serve_model},"
                    f"num_clients=3,top_k=2)")
    got = [ln for ln in out.splitlines() if ln.startswith("client ")]
    check(len(got) == 3, f"serve: {len(got)} of 3 clients answered: {out}")
    for ln in got:
        check(len(ln.split("top-2:")[1].split()) == 2,
              f"serve: short top-k answer: {ln}")
    check("selfcheck ok" in out, f"serve: no selfcheck line: {out}")
    return f"model={ctx.size.serve_model} " + " | ".join(got)


def phase_backend(ctx: Ctx) -> str:
    sz = ctx.size
    out = _run_mode("(mode=rtc_test,n=4096)")
    check(f"plat=xla:{ctx.platform}:" in out, f"backend: rtc_test: {out}")
    tag = out.split("plat=")[1].split(" n=")[0]
    out = _run_mode(f"(mode=cnet_xprof,model=resnet-50,batch={sz.fwd_batch},"
                    f"model_opts=(ysz={sz.hw},xsz={sz.hw},"
                    f"num_classes={NUM_CLASSES}),op_tune={SHIPPED},steps=3)")
    lines = out.splitlines()
    head = next((ln for ln in lines if ln.startswith("cnet_xprof ")), "")
    if ctx.platform == "gpu":
        check("/device:GPU:0" in head,
              f"backend: no kernel events on /device:GPU:0: {out}")
    tot = next((ln for ln in lines if ln.startswith("device total:")), "")
    check(bool(tot), f"backend: empty kernel table: {out}")
    idle = next((ln for ln in lines if ln.startswith("device idle")), "")
    return f"rtc_test plat={tag} | xprof {tot} | {idle}"


PHASES = [("forward", phase_forward), ("default", phase_default),
          ("int8", phase_int8), ("train", phase_train),
          ("serve", phase_serve), ("backend", phase_backend)]


def phase_multichip(ctx: Ctx) -> str:
    """Sharded paths on 4 devices, each against its single-device or
    sequential form (float32 comparisons at HIGHEST precision)."""
    import jax

    import __graft_entry__ as g
    from boda_tpu.parallel.mesh import make_mesh
    devs = jax.devices()
    check(len(devs) >= 4, f"multichip: {len(devs)} devices, need 4")
    mesh = make_mesh(n_devices=4, mp=2, devices=devs[:4])
    sz = ctx.size
    with jax.default_matmul_precision("highest"):
        mrd = g.flagship_sharded_vs_single(mesh, devs[0],
                                           batch=sz.mesh_batch, ysz=sz.hw)
        g.flagship_sharded_train_step(mesh, ysz=sz.hw)
        g._gpipe_resnet50(devs)
        g._gpipe_train_resnet50(devs)
        g._train_1f1b(devs)
    return (f"mesh=(2,2) resnet-50 b{sz.mesh_batch} {sz.hw}x{sz.hw} sharded"
            f"-vs-single mrd={mrd:.3e}; bf16 sharded train step ok; gpipe"
            f" fwd+train and 1F1B match sequential")


def run_phases(ctx: Ctx, phases) -> list[str]:
    """Run each phase; print one line per phase; return failed names."""
    import jax
    failed = []
    events = {"compile": 0.0}

    def on_event(name, secs, **_kw):
        if name == "/jax/core/compile/backend_compile_duration":
            events["compile"] += secs

    jax.monitoring.register_event_duration_secs_listener(on_event)
    try:
        for i, (name, fn) in enumerate(phases, 1):
            events["compile"] = 0.0
            t0 = time.perf_counter()
            try:
                msg = fn(ctx)
                status = "ok"
            except Exception as e:  # report every phase, then fail the run
                traceback.print_exc(file=sys.stderr)
                msg = f"{type(e).__name__}: {str(e)[:500]}"
                status = "FAILED"
                failed.append(name)
            print(f"phase {i} {name}: {status}"
                  f" wall_s={time.perf_counter() - t0:.1f}"
                  f" compile_s={events['compile']:.1f}"
                  f" peak_bytes_in_use={peak_bytes()} {msg}", flush=True)
    finally:
        jax.monitoring.unregister_event_duration_listener(on_event)
    return failed


def result_line(devices) -> str:
    """The last stdout line: the devices as JAX reports them."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded paths, on four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    try:
        import boda_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the boda_tpu package is not beside this script"
              f" ({e})", file=sys.stderr)
        return 2
    import jax
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        print(f"chip_smoke: JAX finds no GPU (devices: {jax.devices()})",
              file=sys.stderr)
        return 1
    if len(gpus) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but {len(gpus)} GPU(s)",
              file=sys.stderr)
        return 1
    from boda_tpu.backend.xla import enable_compilation_cache
    from boda_tpu.core.machine import gpu_power_limit
    cache = enable_compilation_cache()
    print(f"{gpu_power_limit()} | jax.devices()={jax.devices()}"
          f" cache={cache}", flush=True)
    ctx = Ctx(FULL, gpus[0].platform)
    phases = [("multichip", phase_multichip)] if args.chips == 4 else PHASES
    failed = run_phases(ctx, phases)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
