"""cnet_train: a usable training driver (SGD/momentum/Adam over labeled data).

The reference had the full backward machinery (add_bck_ops backward-op
synthesis, conv_util.cc:732-800; BckConv/... kernels, cnn_codegen.cc)
but no solver — training stopped at gradient computation. This mode
completes the surface the JAX way: one jitted train step
(autodiff of the fused program via the ops/mxu_grad custom VJP — bf16
compute, f32 master weights), batches drawn from any labeled
data-stream (`lmdb-src`, `labeled-npy-src`, ...) or a deterministic
synthetic set, loss curve printed/loggable (goldenable via the fixed
seed + CPU numerics), trained weights exportable straight back to
caffemodel (graph/caffe_io.write_caffemodel — the reference's
as_net_param export role, caffepb.cc:593)."""

from __future__ import annotations

import os

import numpy as np

from ..core.config import Attr
from ..core.error import RtErr
from ..core.has_main import mode
from ..graph.modes import _NetMode
from ..io.data_stream import DataBlock, DataStream
from ..ops.cnn_variants import OpTune


OPTIMIZERS = ("sgd", "momentum", "adam")


def init_opt_state(optimizer: str, weights: dict) -> dict:
    """Optimizer state pytree for build_train_step's `vel` argument.
    SGD is stateless (empty dict — no weight-sized copies in HBM)."""
    if optimizer == "momentum":
        return {"v": {k: np.zeros_like(v) for k, v in weights.items()}}
    if optimizer == "adam":
        return {"m": {k: np.zeros_like(v) for k, v in weights.items()},
                "v": {k: np.zeros_like(v) for k, v in weights.items()},
                "t": np.float32(0)}
    return {}


def build_train_step(fwd, data_node: str, top: str, *, lr: float,
                     optimizer: str = "sgd", momentum: float = 0.9,
                     from_logits: bool = False, clip_gradients: float = 0.0,
                     weight_decay: float = 0.0, seed_node: str = "",
                     param_mults: dict = None):
    """Shared fwd+bwd+update step (used by cnet_train and train_bench):
    step(w, vel, xb, labels[, lr_t[, seed_t]]) -> (loss, new_w, new_vel),
    where `vel` is init_opt_state(optimizer, w). Softmax-CE loss
    (log_softmax when `top` is the pre-softmax logits node — log(prob)
    has zero gradient once the softmax saturates); SGD / heavy-ball
    momentum / Adam with f32 master weights; `weight_decay` = caffe
    SolverParameter.weight_decay (L2 reg on the gradient).
    `param_mults`: caffe ParamSpec per weight name -> (lr_mult,
    decay_mult) — decay_mult scales this param's L2 term; lr_mult
    scales its regularized gradient BEFORE the optimizer (caffe
    ComputeUpdateValue semantics: lr_mult=0 freezes the blob AND its
    momentum/adam state; for sgd/constant-lr this equals scaling the
    applied update). `lr_t` (a traced scalar)
    overrides the static lr — LR schedules (warmup/decay) pass it per
    call without recompiling. `seed_node`: when the plan was lowered
    train_dropout=1 it carries a fed dropout-seed input (lower.py
    DROP_SEED_NODE); pass its name and feed the GLOBAL step index as
    `seed_t` so every step draws a fresh dropout mask."""
    import jax
    import jax.numpy as jnp

    if optimizer not in OPTIMIZERS:
        raise RtErr(f"unknown optimizer '{optimizer}' "
                    f"({' | '.join(OPTIMIZERS)})")
    pm = param_mults or {}
    has_mults = any(tuple(m) != (1.0, 1.0) for m in pm.values())

    def _mult_tree(w, ix):
        return {k: float(pm.get(k, (1.0, 1.0))[ix]) for k in w}

    def step(w, vel, xb, labels, lr_t=None, seed_t=None):
        def loss_fn(w):
            ins = {data_node: xb}
            if seed_node:
                if seed_t is None:
                    raise RtErr("build_train_step: plan has a dropout "
                                "seed input — pass seed_t (global step)")
                ins[seed_node] = jnp.asarray(seed_t, jnp.int32)
            p = fwd(ins, w)[top]
            if p.ndim == 4:
                p = p.mean(axis=(2, 3))
            p = p.astype(jnp.float32)
            logp = (jax.nn.log_softmax(p, axis=1) if from_logits
                    else jnp.log(jnp.maximum(p, 1e-30)))
            return -jnp.mean(jnp.take_along_axis(
                logp, labels[:, None], axis=1))

        tmap = jax.tree_util.tree_map
        loss, grads = jax.value_and_grad(loss_fn)(w)
        if clip_gradients:
            # global-norm clipping (caffe SolverParameter.clip_gradients
            # semantics: scale the whole gradient so its L2 norm is at
            # most the threshold) — the plateau-escape steps of BN-less
            # nets spike the gradient norm and diverge without it
            gnorm = jnp.sqrt(sum(
                jnp.sum(jnp.square(g.astype(jnp.float32)))
                for g in jax.tree_util.tree_leaves(grads)))
            scale = jnp.minimum(1.0, clip_gradients
                                / jnp.maximum(gnorm, 1e-12))
            grads = tmap(lambda g: (g.astype(jnp.float32)
                                    * scale).astype(g.dtype), grads)
        if weight_decay:
            # L2 regularization (caffe SGDSolver::Regularize, the default
            # regularization_type=L2): g += wd * decay_mult * w, AFTER
            # clipping and BEFORE the momentum / adaptive update —
            # matching caffe's ApplyUpdate ordering (ClipGradients ->
            # Regularize -> ComputeUpdateValue)
            dm = _mult_tree(w, 1)
            grads = tmap(lambda g, wv, d: (g.astype(jnp.float32)
                                           + weight_decay * d
                                           * wv.astype(jnp.float32))
                         .astype(g.dtype), grads, w, dm)
        if has_mults:
            # lr_mult scales the REGULARIZED gradient before the
            # optimizer (caffe ComputeUpdateValue folds local_rate into
            # the accumulated value): lr_mult=0 keeps momentum/adam
            # state at exactly zero for frozen blobs, matching caffe
            lm = _mult_tree(w, 0)
            grads = tmap(lambda g, m: (g.astype(jnp.float32) * m)
                         .astype(g.dtype), grads, lm)
        if optimizer == "momentum":  # heavy-ball: v'=mu*v+g; w'=w-lr*v'
            vel = {"v": tmap(lambda v, g: jnp.asarray(momentum, v.dtype)
                             * v + g.astype(v.dtype), vel["v"], grads)}
            upd = vel["v"]
        elif optimizer == "adam":
            b1, b2, eps = 0.9, 0.999, 1e-8
            t = vel["t"] + 1
            m = tmap(lambda m, g: b1 * m + (1 - b1) * g.astype(m.dtype),
                     vel["m"], grads)
            v = tmap(lambda v, g: b2 * v
                     + (1 - b2) * jnp.square(g.astype(v.dtype)),
                     vel["v"], grads)
            bc1 = 1 - b1 ** t
            bc2 = 1 - b2 ** t
            upd = tmap(lambda m, v: (m / bc1)
                       / (jnp.sqrt(v / bc2) + eps), m, v)
            vel = {"m": m, "v": v, "t": t}
        else:
            upd = grads
        lr_v = jnp.float32(lr) if lr_t is None else \
            jnp.asarray(lr_t, jnp.float32)
        new_w = tmap(lambda wv, g: wv - lr_v.astype(wv.dtype)
                     * g.astype(wv.dtype), w, upd)
        return loss, new_w, vel

    return step


WTS_MAGIC = b"boda_tpu_trained_weights_v1\n"


def write_weights_artifact(path, weights: dict, *, dtype: str = "bf16",
                           meta: str = "") -> None:
    """Compact trained-weights artifact (checked-in-snapshot role —
    VERDICT r3 #1/#7): {param blob name: array} in the pipe's op_params
    layout (caffe blob order), stored bf16 by default (halves the
    checked-in size; training computes in bf16 anyway so the bf16-rounded
    master weights are the deployed numerics). Not a caffemodel: caffe
    protobuf carries f32 only, and this artifact's job is exact,
    compact round-tripping of OUR trained state."""
    import ml_dtypes
    if dtype not in ("bf16", "f32"):
        raise RtErr(f"write_weights_artifact: dtype must be bf16|f32, "
                    f"got '{dtype}'")
    with open(path, "wb") as f:
        f.write(WTS_MAGIC)
        f.write(f"(n={len(weights)},dtype={dtype},meta={meta})\n".encode())
        for name in sorted(weights):
            v = np.asarray(weights[name], np.float32)
            if dtype == "bf16":
                raw = v.astype(ml_dtypes.bfloat16).view(np.uint16)
            else:
                raw = v
            nb = name.encode()
            f.write(len(nb).to_bytes(4, "little") + nb)
            f.write(len(v.shape).to_bytes(1, "little"))
            for s in v.shape:
                f.write(int(s).to_bytes(4, "little"))
            f.write(np.ascontiguousarray(raw).tobytes())


def read_weights_artifact(path) -> dict:
    """-> {name: f32 array}. Raises RtErr on bad magic / truncation."""
    import ml_dtypes
    from ..core.lexp import parse_lexp
    buf = open(path, "rb").read()
    if not buf.startswith(WTS_MAGIC):
        raise RtErr(f"'{path}' is not a boda_tpu trained-weights artifact")
    try:
        off = len(WTS_MAGIC)
        eol = buf.index(b"\n", off)
        hdr = parse_lexp(buf[off:eol].decode())
        hdr.deep_inc_use_cnt()
        n = int(hdr.get_kid("n").leaf_val)
        dtype = hdr.get_kid("dtype").leaf_val
        off = eol + 1
        out = {}
        for _ in range(n):
            ln = int.from_bytes(buf[off:off + 4], "little")
            off += 4
            name = buf[off:off + ln].decode()
            off += ln
            nd = buf[off]
            off += 1
            shape = []
            for _d in range(nd):
                shape.append(int.from_bytes(buf[off:off + 4], "little"))
                off += 4
            cnt = int(np.prod(shape)) if shape else 1
            if dtype == "bf16":
                raw = np.frombuffer(buf, np.uint16, cnt, off)
                off += 2 * cnt
                v = raw.view(ml_dtypes.bfloat16).astype(np.float32)
            else:
                v = np.frombuffer(buf, np.float32, cnt, off).copy()
                off += 4 * cnt
            out[name] = v.reshape(shape)
        return out
    except RtErr:
        raise
    except Exception as e:
        raise RtErr(f"trained-weights artifact '{path}' is truncated or "
                    f"corrupt: {type(e).__name__}: {e}")


def load_weights_into_pipe(pipe, path) -> None:
    """Apply a trained-weights artifact onto pipe.op_params (validating
    the name/shape sets match the pipe's parameter blobs)."""
    from ..core.dims import NDA
    w = read_weights_artifact(path)
    missing = sorted(set(pipe.op_params) - set(w))[:4]
    if missing:
        raise RtErr(f"weights artifact '{path}' missing params {missing}")
    for name, v in w.items():
        nda = pipe.op_params.get(name)
        if nda is None:
            raise RtErr(f"weights artifact '{path}' has param '{name}' "
                        f"unknown to this net")
        if tuple(nda.dims.shape) != v.shape:
            raise RtErr(f"weights artifact '{path}': param '{name}' shape "
                        f"{v.shape} != net's {tuple(nda.dims.shape)}")
        pipe.op_params[name] = NDA(nda.dims, v.astype(nda.dims.dtype))


SNAP_MAGIC = b"boda_tpu_snapshot_v1\n"


def write_snapshot(path, *, step: int, optimizer: str, consumed: int,
                   weights: dict, vel: dict, losses: list,
                   rng_state) -> None:
    """Solver snapshot (caffe's .solverstate role — the reference never
    reached a solver, so there is no reference format to match; this uses
    the repo's NDA bwrite convention, core/dims.py:373). Contents: step
    counter, stream-consumption count (for deterministic stream resume by
    skip-with-wrap), weights, optimizer state pytree (flattened by path),
    loss history, and the numpy RNG state (bit-identical synthetic-data
    resume)."""
    from ..core.dims import NDA, Dims

    def nda1(v, tn):
        v = np.atleast_1d(np.asarray(v))
        return NDA(Dims.make(tn=tn, v=max(v.size, 1)),
                   v if v.size else np.zeros(1, v.dtype))

    def nda_nd(v):
        v = np.atleast_1d(np.asarray(v, np.float32))
        return NDA.from_array(v, [f"d{i}" for i in range(v.ndim)])

    entries = [("losses", nda1(np.asarray(losses, np.float64), "double")),
               ("rng/keys", nda1(rng_state[1].astype(np.uint32), "uint32_t")),
               ("rng/meta", nda1(np.asarray(
                   [rng_state[2], rng_state[3]], np.int64), "int64_t")),
               ("rng/gauss", nda1(np.asarray(
                   [rng_state[4]], np.float64), "double"))]
    for k, v in sorted(weights.items()):
        entries.append((f"w/{k}", nda_nd(v)))
    for k, v in sorted(_flatten_opt(vel).items()):
        entries.append((f"opt/{k}", nda_nd(v)))
    # write-to-temp + atomic rename: a crash mid-write must not destroy
    # the previous (only) checkpoint — the exact scenario snapshots are for
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(SNAP_MAGIC)
        f.write(f"(step={step},optimizer={optimizer},"
                f"consumed={consumed},n_losses={len(losses)},"
                f"n={len(entries)})\n".encode())
        for name, nda in entries:
            nb = name.encode()
            f.write(len(nb).to_bytes(4, "little") + nb + nda.bwrite())
    os.replace(tmp, path)


def read_snapshot(path) -> dict:
    """→ dict(step, optimizer, consumed, weights, opt_flat, losses,
    rng_state). Raises RtErr on a non-snapshot, truncated, or corrupt
    file (a half-written file is the expected failure artifact of a
    crash, so it must surface as a clean error, not a traceback)."""
    from ..core.dims import NDA
    from ..core.lexp import parse_lexp
    buf = open(path, "rb").read()
    if not buf.startswith(SNAP_MAGIC):
        raise RtErr(f"'{path}' is not a boda_tpu snapshot "
                    f"(bad magic)")

    def want(hdr, k):
        kid = hdr.get_kid(k)
        if kid is None:
            raise RtErr(f"snapshot '{path}': header missing '{k}'")
        return kid.leaf_val

    try:
        off = len(SNAP_MAGIC)
        eol = buf.index(b"\n", off)
        hdr = parse_lexp(buf[off:eol].decode())
        off = eol + 1
        step = int(want(hdr, "step"))
        optimizer = want(hdr, "optimizer")
        consumed = int(want(hdr, "consumed"))
        n_losses = int(want(hdr, "n_losses"))
        n = int(want(hdr, "n"))
        ent = {}
        for _ in range(n):
            ln = int.from_bytes(buf[off:off + 4], "little")
            off += 4
            name = buf[off:off + ln].decode()
            off += ln
            nda, off = NDA.bread(buf, off)
            ent[name] = nda
        keys = ent["rng/keys"].v.astype(np.uint32)
        pos, has_gauss = (int(x) for x in ent["rng/meta"].v)
        rng_state = ("MT19937", keys, pos, has_gauss,
                     float(ent["rng/gauss"].v[0]))
        return {"step": step, "optimizer": optimizer,
                "consumed": consumed,
                "losses": [float(v) for v in ent["losses"].v][:n_losses],
                "rng_state": rng_state,
                "weights": {k[2:]: v.v for k, v in ent.items()
                            if k.startswith("w/")},
                "opt_flat": {k[4:]: v.v for k, v in ent.items()
                             if k.startswith("opt/")}}
    except RtErr:
        raise
    except Exception as e:
        raise RtErr(f"snapshot '{path}' is truncated or corrupt: "
                    f"{type(e).__name__}: {e}")


def _flatten_opt(vel: dict) -> dict:
    """Opt-state pytree → flat {path: leaf} (paths like 'v/conv1_w',
    'm/conv1_w', 't')."""
    flat = {}

    def rec(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = x
    rec("", vel)
    return flat


def _unflatten_opt(optimizer: str, weights: dict, flat: dict) -> dict:
    """Rebuild the opt-state pytree from a flat snapshot dict, validating
    leaf coverage against a fresh init_opt_state skeleton."""
    skel = init_opt_state(optimizer, weights)
    want = _flatten_opt(skel)
    if set(want) != set(flat):
        missing = sorted(set(want) ^ set(flat))[:4]
        raise RtErr(f"snapshot optimizer state doesn't match "
                    f"optimizer '{optimizer}' (mismatched leaves: "
                    f"{missing})")

    def rec(prefix, x):
        if isinstance(x, dict):
            return {k: rec(f"{prefix}/{k}" if prefix else k, v)
                    for k, v in x.items()}
        v = flat[prefix]
        return v.reshape(np.shape(x)).astype(np.asarray(x).dtype) \
            if np.shape(x) else v.reshape(()).astype(np.asarray(x).dtype)
    return rec("", skel)


def check_labels(labels, n_classes: int, what: str) -> None:
    """Out-of-range labels turn into NaN losses via take_along_axis's
    fill mode and masquerade as divergence — refuse them up front."""
    import numpy as np
    mx = int(np.max(labels)) if len(labels) else 0
    if mx >= n_classes or int(np.min(labels) if len(labels) else 0) < 0:
        raise RtErr(f"{what}: label {mx} out of range for {n_classes} "
                    f"output classes (labels must be in [0,{n_classes}))")


@mode("cnet_train", help="train a net: jitted fwd+bwd+update steps over "
                         "a labeled stream (or synthetic data)")
class CnetTrain(_NetMode):
    op_tune = Attr(OpTune,
                   default="(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,"
                           "fuse_siblings=1)",
                   help="tune record (bf16: mixed-precision training via "
                        "the mxu_grad custom VJP)")
    op_tunes_pat = Attr(dict[str, str], default=None,
                        help="per-op tune overrides by TAG REGEX (e.g. "
                             "grad_q8=1 on a site set: int8 weight-"
                             "gradient training experiments)")
    stream = Attr(DataStream, default=None,
                  help="labeled data source, e.g. (mode=lmdb-src,"
                       "fn=...,mean=128); blocks must match the net's "
                       "chan/y/x; labels ride the 'label' subblock. "
                       "Default: deterministic synthetic data")
    steps = Attr(int, default=20)
    lr = Attr(float, default=0.01)
    optimizer = Attr(str, default="sgd", help="sgd | momentum | adam")
    momentum = Attr(float, default=0.9)
    clip_gradients = Attr(float, default=0.0,
                          help="global-L2-norm gradient clipping threshold "
                               "(caffe SolverParameter.clip_gradients "
                               "semantics; 0 = off)")
    weight_decay = Attr(float, default=0.0,
                        help="L2 regularization strength (caffe "
                             "SolverParameter.weight_decay semantics: "
                             "g += wd*w before the momentum update; "
                             "0 = off)")
    num_classes = Attr(int, default=0,
                       help="label range for synthetic data (default: "
                            "the net's output channels)")
    train_dropout = Attr(bool, default=True,
                         help="lower Dropout ops in train mode "
                              "(deterministic seed-keyed masks — the "
                              "reference's det-dropout semantics); 0 = "
                              "inference-mode identity")
    log_every = Attr(int, default=5)
    loss_out_fn = Attr(str, default="", help="write one loss per line")
    weights_out_fn = Attr(str, default="",
                          help="export trained weights as a caffemodel")
    prototxt_out_fn = Attr(str, default="",
                           help="also export the net structure as a "
                                "prototxt (so the trained model round-"
                                "trips through the caffe importer)")
    artifact_out_fn = Attr(str, default="",
                           help="export trained weights as a compact bf16 "
                                "trained-weights artifact "
                                "(write_weights_artifact)")
    warmup_steps = Attr(int, default=0,
                        help="linear LR warmup over this many steps "
                             "(0 = constant lr) — deep BN-folded nets "
                             "trained from scratch need it")
    lr_policy = Attr(str, default="fixed",
                     help="caffe SolverParameter.lr_policy: fixed | "
                          "step (lr*gamma^floor(i/stepsize)) | exp "
                          "(lr*gamma^i) | poly (lr*(1-i/steps)^power) | "
                          "multistep (lr*gamma^#stepvalues-passed); "
                          "composes with warmup_steps")
    gamma = Attr(float, default=0.1, help="step/exp/multistep decay factor")
    stepsize = Attr(int, default=0, help="step policy period (required)")
    power = Attr(float, default=1.0, help="poly policy exponent")
    stepvalue = Attr(list[int], default=None,
                     help="multistep policy boundaries, e.g. '4000 6000'")
    zero_init_pats = Attr(list[str], default=None,
                          help="zero the filts of convs matching these "
                               "tag regexes before training (fixup-style "
                               "residual init, e.g. 'res.*_branch2c': "
                               "each residual block starts as identity, "
                               "which lets BN-folded resnets train from "
                               "scratch)")
    steps_per_call = Attr(int, default=1,
                          help="scan this many optimizer steps inside ONE "
                               "jitted call (batches uploaded together) — "
                               "amortizes per-dispatch latency; steps and "
                               "snapshot_every must be multiples of it")
    seed = Attr(int, default=0)
    snapshot_every = Attr(int, default=0,
                          help="write a solver snapshot (weights + "
                               "optimizer state + RNG + stream position) "
                               "every N steps and at the end; 0 = off")
    snapshot_fn = Attr(str, default="snapshot.boda",
                       help="rolling snapshot filename")
    resume_fn = Attr(str, default="",
                     help="resume from this snapshot: training continues "
                          "to --steps total steps, bit-identical to an "
                          "uninterrupted run (synthetic data via the "
                          "saved RNG state; streams via deterministic "
                          "skip-with-wrap to the saved position)")
    device_data = Attr(bool, default=False,
                       help="stage the ENTIRE dataset into device HBM once "
                            "(uint8 when the stream's mean/scale transform "
                            "is invertible) and gather batches + apply the "
                            "preprocessing on-device — per-step host->device "
                            "traffic drops to one index scalar (a b128 "
                            "224^2 f32 batch alone is 77 MB). Batch order "
                            "and preprocessing "
                            "match the streaming path exactly (loss curves "
                            "agree to float tolerance — the scan program "
                            "fuses differently)")
    eval_stream = Attr(DataStream, default=None,
                       help="held-out labeled stream: staged on-device like "
                            "device_data and scored (top-1) every "
                            "eval_every steps and at the end")
    eval_every = Attr(int, default=0,
                      help="validation cadence in steps (0 = only at end; "
                           "requires eval_stream)")

    def _next_batch(self, d, rng, n_classes):
        """→ (x (img,chan,y,x) f32, labels (img,) i32). Stream blocks
        cycle (re-init on exhaustion) so steps > dataset size works."""
        if self.stream is None:
            x = (rng.randn(*d.shape) * 0.1).astype(np.float32)
            labels = rng.randint(0, n_classes, size=(d["img"],))
            return x, labels.astype(np.int32)
        xs, ls = [], []
        while len(xs) < d["img"]:
            db = self._next_stream_block()
            v = np.asarray(db.nda.v, np.float32)
            if v.shape != tuple(d.shape[1:]):
                raise RtErr(f"cnet_train: stream block shape {v.shape} != "
                            f"net input {tuple(d.shape[1:])} — resize the "
                            f"stream or set in_dims to match")
            lab = db.get_sdb("label")
            if lab is None:
                raise RtErr("cnet_train: stream block has no 'label' "
                            "subblock (use a labeled source)")
            xs.append(v)
            ls.append(int(np.asarray(lab.nda.v).reshape(-1)[0]))
        return np.stack(xs), np.asarray(ls, np.int32)

    def _stage_stream_on_device(self, stream, d, what: str):
        """Drain `stream` once and stage it as device arrays:
        → (ds (N,chan,y,x) u8|f32 jax array, labels (N,) i32 jax array,
        mean, scale) where the logical input is (ds.astype(f32)-mean)*scale
        — bit-identical to the host preprocessing ((u8-mean)*scale in f32)
        when the stream's transform is invertible (pixels recover exactly
        as uint8), else staged as raw f32 with mean=0/scale=1."""
        import jax
        stream.data_stream_init()
        m = getattr(stream, "mean", None)
        s = getattr(stream, "scale", None)
        invertible = isinstance(m, float) and isinstance(s, float) and s
        imgs, labels = [], []
        while True:
            db = stream.proc_block(DataBlock())
            if not db.valid():
                break
            v = np.asarray(db.nda.v, np.float32)
            if v.shape != tuple(d.shape[1:]):
                raise RtErr(f"cnet_train {what}: stream block shape "
                            f"{v.shape} != net input {tuple(d.shape[1:])}")
            lab = db.get_sdb("label")
            if lab is None:
                raise RtErr(f"cnet_train {what}: stream block has no "
                            f"'label' subblock (use a labeled source)")
            if invertible:
                u = v / s + m
                ui = np.rint(u)
                if abs(u - ui).max() < 1e-3 and ui.min() >= 0 \
                        and ui.max() <= 255:
                    v = ui.astype(np.uint8)
                else:
                    raise RtErr(
                        f"cnet_train {what}: stream transform "
                        f"(mean={m},scale={s}) doesn't invert to uint8 "
                        f"pixels — stage a u8-exact stream or use the "
                        f"host streaming path")
            imgs.append(v)
            labels.append(int(np.asarray(lab.nda.v).reshape(-1)[0]))
        if not imgs:
            raise RtErr(f"cnet_train {what}: stream yielded no blocks")
        mean, scale = (float(m), float(s)) if invertible else (0.0, 1.0)
        ds = jax.device_put(np.stack(imgs))
        labs = jax.device_put(np.asarray(labels, np.int32))
        kind = "u8" if invertible else "f32"
        print(f"{what}: staged {len(imgs)} {kind} images "
              f"({ds.nbytes / 1e6:.0f} MB) on device", flush=True)
        return ds, labs, mean, scale

    def _log_losses(self, i: int, new_losses, losses) -> int:
        for dloss in new_losses:
            losses.append(dloss)
            i += 1
            if not np.isfinite(dloss):
                raise RtErr(f"cnet_train: non-finite loss at step "
                            f"{i - 1}: {dloss} (reduce --lr)")
            if i % self.log_every == 0 or i == self.steps:
                print(f"step {i:4d}/{self.steps}: "
                      f"loss={dloss:.5f}", flush=True)
        return i

    def _make_eval_fn(self, fwd, data_node, top, b, d):
        """Whole-val-set top-1 scorer over a device-staged (ds, labs):
        one jitted call scans the set in net-batch slices (short final
        batch padded; pad labels -1 never match). -> correct count."""
        import jax
        import jax.numpy as jnp

        def eval_fn(w, ds, labs, mean, scale):
            n = ds.shape[0]
            nb = (n + b - 1) // b
            pad = nb * b - n
            ds_p = jnp.pad(ds, ((0, pad),) + ((0, 0),) * (ds.ndim - 1))
            labs_p = jnp.pad(labs, (0, pad), constant_values=-1)

            def body(i, acc):
                xb = jax.lax.dynamic_slice_in_dim(ds_p, i * b, b, 0)
                xb = (xb.astype(jnp.float32) - mean) * scale
                p = fwd({data_node: xb}, w)[top]
                if p.ndim == 4:
                    p = p.mean(axis=(2, 3))
                pred = jnp.argmax(p.astype(jnp.float32), axis=1)
                lb = jax.lax.dynamic_slice_in_dim(labs_p, i * b, b, 0)
                return acc + jnp.sum((pred == lb) & (lb >= 0))
            return jax.lax.fori_loop(0, nb, body, jnp.int32(0))
        return eval_fn

    def _print_eval(self, eval_fn, weights, ev, i: int) -> None:
        ds, labs, mean, scale = ev
        pos = int(eval_fn(weights, ds, labs, np.float32(mean),
                          np.float32(scale)))
        n = int(labs.shape[0])
        self._last_eval = (pos, n)
        print(f"eval @ step {i}: top_1_acc={pos / n:g} "
              f"num_pos={pos} num_test={n}", flush=True)

    def _next_stream_block(self) -> DataBlock:
        """One valid stream block, wrapping on EOF; counts consumed
        blocks so snapshots can restore the stream position by replaying
        the same skip-with-wrap sequence."""
        db = self.stream.proc_block(DataBlock())
        if not db.valid():
            self.stream.data_stream_init()  # wrap around (epoch)
            db = self.stream.proc_block(DataBlock())
            if not db.valid():
                raise RtErr("cnet_train: stream yielded no blocks")
        self._consumed += 1
        return db

    def main(self):
        import jax

        from ..backend.xla import enable_compilation_cache
        from ..engine.lower import lower_pipe, resolve_plan_weights
        from ..engine.rtc_fwd import build_fused_forward
        from ..graph.modes import _load_pipe

        if self.optimizer not in OPTIMIZERS:
            raise RtErr(f"cnet_train: unknown optimizer '{self.optimizer}' "
                        f"({' | '.join(OPTIMIZERS)})")
        if self.steps < 1:
            raise RtErr("cnet_train: steps must be >= 1")
        enable_compilation_cache()
        pipe = _load_pipe(self)
        if self.zero_init_pats:
            import re

            from ..core.dims import NDA
            rxs = [re.compile(p) for p in self.zero_init_pats]
            nz = 0
            for op in pipe.ops.values():
                if op.type not in ("Convolution", "Deconvolution",
                                   "InnerProduct") or len(op.bots) < 2:
                    continue
                if any(rx.fullmatch(op.tag) for rx in rxs):
                    nda = pipe.op_params.get(op.bots[1])
                    if nda is not None:
                        pipe.op_params[op.bots[1]] = \
                            NDA(nda.dims, np.zeros_like(nda.v))
                        nz += 1
            if not nz:
                raise RtErr("cnet_train: zero_init_pats matched no "
                            "weighted ops")
            print(f"zero-initialized filts of {nz} op(s) "
                  f"(fixup-style residual init)", flush=True)
        op_tunes = None
        if self.op_tunes_pat:
            from .cnet_bench import pat_tunes
            op_tunes = pat_tunes(pipe, self.op_tunes_pat)
        plan = lower_pipe(pipe, self.op_tune, op_tunes=op_tunes,
                          fused_storage=True,
                          train_dropout=self.train_dropout)
        weights = resolve_plan_weights(plan, pipe.op_params)
        data_node = pipe.data_img_node_names[0]
        top = "prob" if "prob" in plan.output_nodes else plan.output_nodes[-1]
        # train on the LOGITS (the Softmax op's input) via log_softmax:
        # log(prob) has zero gradient once the softmax saturates (p_true
        # underflows to 0 — e.g. raw-scale caffe inputs on a fresh net)
        top_op = next((op for op in pipe.ops.values() if top in op.tops),
                      None)
        from_logits = top_op is not None and top_op.type == "Softmax"
        if from_logits:
            top = top_op.bots[0]
        # surface the logits via extra_out_nodes — keep_all_nodes would
        # keep EVERY intermediate fetchable and defeat whole-net fusion
        # (~9x slower on the resnet-50 bwd, measured via the stage probe)
        fwd = build_fused_forward(plan,
                                  extra_out_nodes=(top,)
                                  if top not in plan.output_nodes else ())
        d = pipe.get_data_img_dims()
        n_classes = self.num_classes or plan.node_dims[top].shape[1]
        n_out = plan.node_dims[top].shape[1]
        b = d["img"]
        ds_dev = None
        if self.device_data:
            if self.stream is None:
                raise RtErr("cnet_train: device_data=1 requires a stream "
                            "(synthetic batches are host-generated)")
            ds_dev, labs_dev, ds_mean, ds_scale = \
                self._stage_stream_on_device(self.stream, d, "train set")
            check_labels(np.asarray(labs_dev), n_out, "cnet_train")
            n_ds = int(ds_dev.shape[0])
        elif self.stream is not None:
            self.stream.data_stream_init()
        ev = None
        fwd_ev = None
        if self.eval_stream is not None:
            ev = self._stage_stream_on_device(self.eval_stream, d,
                                              "eval set")
            check_labels(np.asarray(ev[1]), n_out, "cnet_train eval")
            # evaluation runs the INFERENCE forward (dropout = identity);
            # the trained weights dict feeds it directly (same weight
            # nodes — dropout lowering adds none)
            plan_ev = lower_pipe(pipe, self.op_tune, op_tunes=op_tunes,
                                 fused_storage=True)
            fwd_ev = build_fused_forward(
                plan_ev, extra_out_nodes=(top,)
                if top not in plan_ev.output_nodes else ())
        elif self.eval_every:
            raise RtErr("cnet_train: eval_every requires eval_stream")
        self._consumed = 0
        rng = np.random.RandomState(self.seed)
        from ..engine.lower import DROP_SEED_NODE
        seed_node = DROP_SEED_NODE \
            if DROP_SEED_NODE in plan.input_nodes else ""
        # caffe ParamSpec mults (imported prototxts; zoo nets have none):
        # map pipe.param_mults through any weight-transform aliasing
        mults = {}
        for n in weights:
            src = plan.weight_transforms.get(n, (n, None))[0]
            if src in pipe.param_mults:
                mults[n] = pipe.param_mults[src]
        if mults:
            print(f"honoring caffe param mults on {len(mults)} "
                  f"weight blob(s)", flush=True)
        step = jax.jit(build_train_step(
            fwd, data_node, top, lr=self.lr, optimizer=self.optimizer,
            momentum=self.momentum, from_logits=from_logits,
            clip_gradients=self.clip_gradients,
            weight_decay=self.weight_decay, seed_node=seed_node,
            param_mults=mults))

        vel = init_opt_state(self.optimizer, weights)
        losses = []
        start = 0
        if self.resume_fn:
            snap = read_snapshot(self.resume_fn)
            if snap["optimizer"] != self.optimizer:
                raise RtErr(f"cnet_train: snapshot was taken with "
                            f"optimizer '{snap['optimizer']}', not "
                            f"'{self.optimizer}'")
            if set(snap["weights"]) != set(weights):
                raise RtErr("cnet_train: snapshot weights don't match "
                            "this net's parameter set")
            for k, v in weights.items():
                # snapshot arrays are stored flat-shaped-as-written; a
                # silent reshape across a mismatched net variant (e.g.
                # resized conv, changed in_dims) would scramble weights
                if snap["weights"][k].shape != np.shape(v):
                    raise RtErr(
                        f"cnet_train: snapshot weight '{k}' shape "
                        f"{snap['weights'][k].shape} != net's "
                        f"{np.shape(v)} — the snapshot is from a "
                        f"different net variant")
            start = snap["step"]
            if start >= self.steps:
                raise RtErr(f"cnet_train: snapshot is already at step "
                            f"{start} >= --steps={self.steps}")
            weights = {k: snap["weights"][k] for k in weights}
            vel = _unflatten_opt(self.optimizer, weights, snap["opt_flat"])
            losses = snap["losses"]
            rng.set_state(snap["rng_state"])
            if self.device_data:
                # staged batches are pure functions of the step index — no
                # stream replay needed to restore the position
                self._consumed = snap["consumed"]
            elif self.stream is not None:
                for _ in range(snap["consumed"]):
                    self._next_stream_block()
                self._consumed = snap["consumed"]
            print(f"resumed from {self.resume_fn} at step {start}")
        warm = self.warmup_steps
        pol = self.lr_policy
        if pol not in ("fixed", "step", "exp", "poly", "multistep"):
            raise RtErr(f"cnet_train: unknown lr_policy '{pol}' (fixed | "
                        f"step | exp | poly | multistep)")
        if pol == "step" and self.stepsize < 1:
            raise RtErr("cnet_train: lr_policy=step requires stepsize >= 1")
        if pol == "multistep" and not self.stepvalue:
            raise RtErr("cnet_train: lr_policy=multistep requires "
                        "stepvalue boundaries")

        def policy_lr(i):
            # caffe SGDSolver::GetLearningRate formulas, keyed by the
            # GLOBAL step index (resume-stable)
            if pol == "step":
                return self.lr * self.gamma ** (i // self.stepsize)
            if pol == "exp":
                return self.lr * self.gamma ** i
            if pol == "poly":
                return self.lr * max(0.0, 1.0 - i / self.steps) ** self.power
            if pol == "multistep":
                return self.lr * self.gamma ** sum(
                    1 for sv in self.stepvalue if i >= sv)
            return self.lr

        def lr_at(i):
            v = policy_lr(i)
            return v * min(1.0, (i + 1) / warm) if warm else v

        dyn_lr = bool(warm) or pol != "fixed"

        K = self.steps_per_call
        if K < 1:
            raise RtErr("cnet_train: steps_per_call must be >= 1")
        if K > 1:
            if (self.steps - start) % K:
                raise RtErr(f"cnet_train: steps ({self.steps}) minus the "
                            f"resume point ({start}) must be a multiple of "
                            f"steps_per_call ({K})")
            if self.snapshot_every and self.snapshot_every % K:
                raise RtErr("cnet_train: snapshot_every must be a multiple "
                            "of steps_per_call")

            def chunk_fn(w, vel, xs, ls, lrs, seeds):
                def body(carry, inp):
                    loss, w2, v2 = step(*carry, inp[0], inp[1], inp[2],
                                        inp[3] if seed_node else None)
                    return (w2, v2), loss
                (w, vel), lk = jax.lax.scan(body, (w, vel),
                                            (xs, ls, lrs, seeds))
                return lk, w, vel
            chunk = jax.jit(chunk_fn)
        if self.device_data:
            import jax.numpy as jnp

            # batches gathered from the HBM-staged dataset inside the scan:
            # global step t covers staged indices [t*b, t*b+b) mod N — the
            # exact skip-with-wrap order of the streaming path, with the
            # same (u8→f32 - mean) * scale f32 preprocessing
            def dd_chunk_fn(w, vel, ds, labs, ix0s, lrs, seeds):
                def body(carry, inp):
                    ix0, lr_t, seed_t = inp
                    ix = (ix0 + jnp.arange(b, dtype=jnp.int32)) % n_ds
                    xb = (jnp.take(ds, ix, axis=0).astype(jnp.float32)
                          - ds_mean) * ds_scale
                    loss, w2, v2 = step(*carry, xb,
                                        jnp.take(labs, ix, axis=0), lr_t,
                                        seed_t if seed_node else None)
                    return (w2, v2), loss
                (w, vel), lk = jax.lax.scan(body, (w, vel),
                                            (ix0s, lrs, seeds))
                return lk, w, vel
            dd_chunk = jax.jit(dd_chunk_fn)
        eval_fn = None
        if ev is not None:
            eval_fn = jax.jit(self._make_eval_fn(
                fwd_ev, data_node, top, b, d))
        i = start
        while i < self.steps:
            if self.device_data:
                k_now = min(K, self.steps - i)
                lrs = np.asarray([lr_at(j) for j in range(i, i + k_now)],
                                 np.float32)
                ix0s = np.asarray([(j * b) % n_ds
                                   for j in range(i, i + k_now)], np.int32)
                seeds = np.arange(i, i + k_now, dtype=np.int32)
                lk, weights, vel = dd_chunk(weights, vel, ds_dev, labs_dev,
                                            ix0s, lrs, seeds)
                self._consumed += k_now * b
                new_losses = [float(v) for v in np.asarray(lk)]
                i = self._log_losses(i, new_losses, losses)
                if eval_fn is not None and self.eval_every \
                        and (i % self.eval_every == 0 and i < self.steps):
                    self._print_eval(eval_fn, weights, ev, i)
                if self.snapshot_every and (i % self.snapshot_every == 0
                                            or i == self.steps):
                    write_snapshot(
                        self.out_path(self.snapshot_fn), step=i,
                        optimizer=self.optimizer, consumed=self._consumed,
                        weights={k: np.asarray(v)
                                 for k, v in weights.items()},
                        vel=jax.tree_util.tree_map(np.asarray, vel),
                        losses=losses, rng_state=rng.get_state())
                continue
            xs, ls = [], []
            for _ in range(min(K, self.steps - i)):
                x, labels = self._next_batch(d, rng, n_classes)
                check_labels(labels, n_out, "cnet_train")
                xs.append(x)
                ls.append(labels)
            if K == 1:
                if seed_node:
                    loss, weights, vel = step(
                        weights, vel, xs[0], ls[0],
                        np.float32(lr_at(i)) if dyn_lr else None,
                        np.int32(i))
                else:
                    # default path: exact historical call shape (goldens)
                    loss, weights, vel = \
                        step(weights, vel, xs[0], ls[0]) if not dyn_lr \
                        else step(weights, vel, xs[0], ls[0],
                                  np.float32(lr_at(i)))
                new_losses = [float(loss)]
            else:
                lrs = np.asarray([lr_at(j) for j in range(i, i + K)],
                                 np.float32)
                lk, weights, vel = chunk(weights, vel, np.stack(xs),
                                         np.stack(ls), lrs,
                                         np.arange(i, i + K,
                                                   dtype=np.int32))
                new_losses = [float(v) for v in np.asarray(lk)]
            i = self._log_losses(i, new_losses, losses)
            if eval_fn is not None and self.eval_every \
                    and (i % self.eval_every == 0 and i < self.steps):
                self._print_eval(eval_fn, weights, ev, i)
            if self.snapshot_every and (i % self.snapshot_every == 0
                                        or i == self.steps):
                write_snapshot(
                    self.out_path(self.snapshot_fn), step=i,
                    optimizer=self.optimizer, consumed=self._consumed,
                    weights={k: np.asarray(v) for k, v in weights.items()},
                    vel=jax.tree_util.tree_map(np.asarray, vel),
                    losses=losses, rng_state=rng.get_state())
        if eval_fn is not None:
            self._print_eval(eval_fn, weights, ev, i)
        print(f"cnet_train {self.model or self.ptt_fn} b{d['img']} "
              f"opt={self.optimizer} lr={self.lr}: "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f} "
              f"({self.steps} steps)")
        if self.loss_out_fn:
            self.out_path(self.loss_out_fn).write_text(
                "".join(f"{v:.6f}\n" for v in losses))
        if self.weights_out_fn:
            from ..core.dims import NDA
            from ..graph.caffe_io import write_caffemodel
            for n, v in weights.items():
                pipe.op_params[n] = NDA(pipe.op_params[n].dims,
                                        np.asarray(v, np.float32))
            write_caffemodel(pipe, self.out_path(self.weights_out_fn))
            print(f"wrote trained weights to {self.weights_out_fn}")
        if self.prototxt_out_fn:
            from ..graph.caffe_io import write_prototxt
            write_prototxt(pipe, self.out_path(self.prototxt_out_fn))
            print(f"wrote net structure to {self.prototxt_out_fn}")
        if self.artifact_out_fn:
            write_weights_artifact(
                self.out_path(self.artifact_out_fn),
                {k: np.asarray(v) for k, v in weights.items()},
                meta=f"{self.model or self.ptt_fn}:steps={self.steps}")
            print(f"wrote trained-weights artifact to "
                  f"{self.artifact_out_fn}")
