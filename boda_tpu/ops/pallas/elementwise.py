"""Elementwise / data-movement kernel templates.

Reference parity: test/rtc/{dot,copy,split_copy,relu,ZeroIfNonPos,dropout}
.cucl and the eltwise ops lowered by rtc_fwd (Concat→copy calls
rtc_fwd.cc:267-280, Split :281-294, in-place ReLU/Dropout :330-358).
These are VPU-bound; XLA fuses them well, so templates are thin jnp bodies
(the Pallas win is in matmul/conv; hand-fusing elementwise into those is
done via fusion flags there, mirroring conv_has_relu).
"""

from __future__ import annotations

import numpy as np

from ..op_base import OpBase
from ..registry import IN, INOUT, OUT, KernelTemplate, adecl, template


@template
class Dot(KernelTemplate):
    """Backend smoke-test kernel (reference: rtc_test's dot.cucl,
    rtc_compute.cc:135): c = a * b elementwise over a 1-D index space."""

    name = "dot"
    args = [adecl("a", IN, "n"), adecl("b", IN, "n"), adecl("c", OUT, "n")]

    @classmethod
    def build(cls, rfs: OpBase):
        def fn(a, b):
            return a * b
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, a, b):
        return np.asarray(a) * np.asarray(b)


@template
class Copy(KernelTemplate):
    """Copy `in` into a chan-offset slice of `out` (Concat lowering;
    reference: copy.cucl with ocix offset, rtc_fwd.cc:267-280)."""

    name = "copy"
    args = [adecl("in", IN, "img chan y x"),
            adecl("out", INOUT, "img chan y x")]
    sig_nda_keys = ["ocix"]
    nhwc_ok = True

    @classmethod
    def build(cls, rfs: OpBase):
        import jax
        ocix = rfs.get_u32_or("ocix", 0)
        cn = rfs.get_dims("in")["chan"]
        nhwc = rfs.str_vals.get("io_layout") == "nhwc"

        def fn(x, out):
            at = (0, 0, 0, ocix) if nhwc else (0, ocix, 0, 0)
            return jax.lax.dynamic_update_slice(out, x.astype(out.dtype), at)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, out):
        ocix = rfs.get_u32_or("ocix", 0)
        out = np.array(out)
        out[:, ocix:ocix + x.shape[1]] = x
        return out


@template
class SplitCopy(KernelTemplate):
    """Copy a chan-offset slice of `in` into `out` (Split lowering;
    reference: split_copy.cucl, rtc_fwd.cc:281-294)."""

    name = "split_copy"
    args = [adecl("in", IN, "img chan y x"),
            adecl("out", OUT, "img chan y x")]
    sig_nda_keys = ["icix"]
    nhwc_ok = True

    @classmethod
    def build(cls, rfs: OpBase):
        icix = rfs.get_u32_or("icix", 0)
        cn = rfs.get_dims("out")["chan"]
        nhwc = rfs.str_vals.get("io_layout") == "nhwc"

        def fn(x):
            return x[..., icix:icix + cn] if nhwc else x[:, icix:icix + cn]
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        icix = rfs.get_u32_or("icix", 0)
        cn = rfs.get_dims("out")["chan"]
        return np.asarray(x)[:, icix:icix + cn]


@template
class Relu(KernelTemplate):
    """In-place ReLU (reference: relu.cucl; usually fused into conv via
    conv_has_relu — this standalone form covers unfused graph positions)."""

    name = "relu"
    args = [adecl("inout", INOUT, "img chan y x")]
    nhwc_ok = True  # elementwise: storage-layout agnostic

    @classmethod
    def build(cls, rfs: OpBase):
        import jax.numpy as jnp

        def fn(x):
            return jnp.maximum(x, 0)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        return np.maximum(np.asarray(x), 0)


@template
class ZeroIfNonPos(KernelTemplate):
    """ReLU backward: out = grad where in > 0 else 0 (reference:
    ZeroIfNonPos.cucl, emitted by add_bck_ops conv_util.cc:732-800)."""

    name = "ZeroIfNonPos"
    args = [adecl("in", IN, "img chan y x"),
            adecl("grad", IN, "img chan y x"),
            adecl("out", OUT, "img chan y x")]

    @classmethod
    def build(cls, rfs: OpBase):
        import jax.numpy as jnp

        def fn(x, g):
            return jnp.where(x > 0, g, 0).astype(g.dtype)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, g):
        return np.where(np.asarray(x) > 0, np.asarray(g), 0).astype(np.asarray(g).dtype)


@template
class Eltwise(KernelTemplate):
    """Binary eltwise (SUM/MAX/PROD over two inputs) — caffe Eltwise layer
    (caffepb.cc Eltwise extraction); residual adds in resnets."""

    name = "eltwise"
    args = [adecl("a", IN, "img chan y x"), adecl("b", IN, "img chan y x"),
            adecl("out", OUT, "img chan y x")]
    sig_str_keys = ["ew_op"]
    nhwc_ok = True  # elementwise: storage-layout agnostic

    @classmethod
    def build(cls, rfs: OpBase):
        import jax.numpy as jnp
        op = rfs.str_vals.get("ew_op", "SUM")

        def fn(a, b):
            if op == "SUM":
                return a + b
            if op == "MAX":
                return jnp.maximum(a, b)
            if op == "PROD":
                return a * b
            raise ValueError(f"unknown ew_op {op}")
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, a, b):
        op = rfs.str_vals.get("ew_op", "SUM")
        a, b = np.asarray(a), np.asarray(b)
        return {"SUM": a + b, "MAX": np.maximum(a, b), "PROD": a * b}[op]


@template
class Scale(KernelTemplate):
    """Per-channel scale+bias (caffe Scale layer; also BatchNorm folding)."""

    name = "scale"
    args = [adecl("in", IN, "img chan y x"), adecl("scales", IN, "chan"),
            adecl("biases", IN, "chan", opt=True),
            adecl("out", OUT, "img chan y x")]
    nhwc_ok = True

    @classmethod
    def build(cls, rfs: OpBase):
        has_bias = "biases" in rfs.nda_vals
        nhwc = rfs.str_vals.get("io_layout") == "nhwc"

        def fn(x, s, b=None):
            sh = s[None, None, None, :] if nhwc else s[None, :, None, None]
            y = x * sh.astype(x.dtype)
            if has_bias and b is not None:
                bh = b[None, None, None, :] if nhwc else b[None, :, None, None]
                y = y + bh.astype(x.dtype)
            return y
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, s, b=None):
        y = np.asarray(x) * np.asarray(s)[None, :, None, None]
        if b is not None:
            y = y + np.asarray(b)[None, :, None, None]
        return y


@template
class Dropout(KernelTemplate):
    """Dropout with deterministic seed control (reference: dropout.cucl +
    set_det_drop_seed rtc_fwd.cc:91-99). Inference mode is identity; train
    mode masks with keep-prob scaling using a counter-based PRNG so results
    are reproducible across backends given the same seed."""

    name = "dropout"
    args = [adecl("seed", IN, "v", opt=True),
            adecl("inout", INOUT, "img chan y x")]
    nhwc_ok = True  # elementwise; det mask is index-based (layout-stable
    # per storage shape — train-mode masks are sig-keyed on io_layout)
    sig_nda_keys = ["dropout_ratio", "det_drop_seed"]
    sig_str_keys = ["drop_mode"]

    @classmethod
    def _mask(cls, rfs: OpBase, shape):
        # deterministic counter-based mask identical in numpy and jax:
        # threefry via jax is impractical to mirror in numpy, so both
        # backends use this explicit LCG-on-index pattern.
        seed = rfs.get_u32_or("det_drop_seed", 0)
        idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
        h = (idx * np.uint64(6364136223846793005) + np.uint64(seed * 2654435761 + 1442695040888963407))
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xff51afd7ed558ccd)
        h ^= h >> np.uint64(33)
        u = (h >> np.uint64(40)).astype(np.float64) / float(1 << 24)
        return u.reshape(shape)

    # ---- per-STEP seeded mask (training; seed is a traced scalar) ----
    # The static `_mask` above bakes ONE mask per signature at trace
    # time — fine for cross-backend determinism tests, but a training
    # run would drop the SAME units every step (fixed pruning, zero
    # stochastic regularization; caffe redraws the mask per iteration,
    # dropout_layer.cpp). The seeded form computes the mask IN-GRAPH
    # from a fed step counter: 32-bit murmur3-fmix on (index, seed) —
    # uint32 only (no u64 arithmetic needed), with an exact numpy twin for the
    # ref engine. Gated on the optional 'seed' arg so every existing
    # static-mask signature (and its goldens) is untouched.
    _FMIX = (2654435761, 0x9E3779B9, 0x85EB_CA6B, 0xC2B2_AE35)

    @classmethod
    def _mask32_np(cls, seed, shape):
        m = np.uint32
        c1, c2, c3, c4 = (m(v) for v in cls._FMIX)
        idx = np.arange(int(np.prod(shape)), dtype=np.uint32)
        with np.errstate(over="ignore"):
            h = idx * c1 + m(np.uint32(seed)) * c2
            h ^= h >> m(16)
            h *= c3
            h ^= h >> m(13)
            h *= c4
            h ^= h >> m(16)
        return ((h >> m(8)).astype(np.float64) / float(1 << 24)) \
            .reshape(shape)

    @classmethod
    def _mask32_jnp(cls, seed, shape):
        import jax.numpy as jnp
        c1, c2, c3, c4 = (jnp.uint32(v) for v in cls._FMIX)
        n = int(np.prod(shape))
        idx = jnp.arange(n, dtype=jnp.uint32)
        h = idx * c1 + seed.reshape(()).astype(jnp.uint32) * c2
        h = h ^ (h >> jnp.uint32(16))
        h = h * c3
        h = h ^ (h >> jnp.uint32(13))
        h = h * c4
        h = h ^ (h >> jnp.uint32(16))
        u = (h >> jnp.uint32(8)).astype(jnp.float32) \
            * jnp.float32(1.0 / (1 << 24))
        return u.reshape(shape)

    @classmethod
    def build(cls, rfs: OpBase):
        import jax.numpy as jnp
        if rfs.str_vals.get("drop_mode", "infer") == "infer":
            return lambda x: x
        ratio_nda = rfs.nda_vals.get("dropout_ratio")
        ratio = float(ratio_nda.item()) if ratio_nda is not None else 0.5
        if "seed" in rfs.nda_vals:
            # per-step seeded mask; arg order is in_args then io_args
            def fn_seeded(seed, x):
                u = cls._mask32_jnp(seed, x.shape)
                keep = (u >= ratio).astype(x.dtype)
                return x * keep / (1.0 - ratio)
            return fn_seeded
        # mask is baked per (seed, shape) signature — deterministic
        def fn(x):
            u = jnp.asarray(cls._mask(rfs, x.shape), dtype=x.dtype)
            keep = (u >= ratio).astype(x.dtype)
            return x * keep / (1.0 - ratio)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, *a):
        if len(a) == 2:  # seeded train form: (seed, x)
            seed, x = a
            x = np.asarray(x)
            ratio_nda = rfs.nda_vals.get("dropout_ratio")
            ratio = float(ratio_nda.item()) if ratio_nda is not None else 0.5
            u = cls._mask32_np(int(np.asarray(seed).reshape(())), x.shape)
            return x * (u >= ratio).astype(x.dtype) / (1.0 - ratio)
        x = np.asarray(a[0])
        if rfs.str_vals.get("drop_mode", "infer") == "infer":
            return x
        ratio_nda = rfs.nda_vals.get("dropout_ratio")
        ratio = float(ratio_nda.item()) if ratio_nda is not None else 0.5
        u = cls._mask(rfs, x.shape)
        return x * (u >= ratio).astype(x.dtype) / (1.0 - ratio)
