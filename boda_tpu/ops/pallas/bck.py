"""Backward-op kernel templates (reference: BckConv.cucl, bconv*.cucl,
Spreading.cucl, bck_lrn.cucl, BckDropout; synthesized into the graph by
add_bck_ops, conv_util.cc:732-800).

The reference hand-wrote each gradient kernel; this design derives
device gradients with jax.vjp over the forward builders (exact, fused by
XLA) while keeping independent numpy reference implementations so the
cross-backend digest tests still compare two *independent* derivations.
"""

from __future__ import annotations

import numpy as np

from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template



def _bck_conv_params(rfs: OpBase):
    """BckConv sigs carry out_grad (not out); extract geometry directly."""
    st = rfs.get_dims_or_none("stride")
    pad = rfs.get_dims_or_none("in_pad")
    sy, sx = (st["y"], st["x"]) if st else (1, 1)
    py, px = (pad["y"], pad["x"]) if pad else (0, 0)
    return sy, sx, py, px


@template
class BckConv(KernelTemplate):
    """Conv backward: (in, filts, out_grad) → (in_grad, filts_grad,
    biases_grad). Reference lowers BckConv to 3 calls (rtc_fwd.cc:378-401);
    here one fused vjp program produces all three."""

    name = "BckConv"
    args = [adecl("in", IN, "img chan y x"),
            adecl("filts", IN, "out_chan in_chan y x"),
            adecl("out_grad", IN, "img chan y x"),
            adecl("in_grad", OUT, "img chan y x"),
            adecl("filts_grad", OUT, "out_chan in_chan y x"),
            adecl("biases_grad", OUT, "out_chan")]
    sig_nda_keys = ["in_pad", "stride", "kern_sz"]

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        ogd = rfs.get_dims("out_grad")
        fd = rfs.get_dims("filts")
        return 3 * 2 * ogd.sz() * fd["in_chan"] * fd["y"] * fd["x"]

    @classmethod
    def build(cls, rfs: OpBase):
        import jax
        import jax.numpy as jnp
        sy, sx, py, px = _bck_conv_params(rfs)

        from ..precision import dot_precision

        def fwd(x, w):
            return jax.lax.conv_general_dilated(
                x, w, window_strides=(sy, sx), padding=((py, py), (px, px)),
                dimension_numbers=("NCHW", "OIHW", "NCHW"),
                preferred_element_type=jnp.float32,
                precision=dot_precision(x.dtype))

        def fn(x, w, og):
            _y, vjp = jax.vjp(fwd, x, w)
            dx, dw = vjp(og.astype(jnp.float32))
            db = jnp.sum(og, axis=(0, 2, 3))
            return dx.astype(x.dtype), dw.astype(w.dtype), db.astype(w.dtype)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, w, og):
        sy, sx, py, px = _bck_conv_params(rfs)
        x = np.asarray(x, np.float64)
        w = np.asarray(w, np.float64)
        og = np.asarray(og, np.float64)
        n, C, H, W = x.shape
        oc, ic, ky, kx = w.shape
        oy, ox = og.shape[2], og.shape[3]
        xp = np.pad(x, ((0, 0), (0, 0), (py, py), (px, px)))
        dxp = np.zeros_like(xp)
        dw = np.zeros_like(w)
        for yy in range(ky):
            for xx in range(kx):
                win = xp[:, :, yy:yy + oy * sy:sy, xx:xx + ox * sx:sx][:, :, :oy, :ox]
                dw[:, :, yy, xx] = np.einsum("nohw,nchw->oc", og, win, optimize=True)
                dxp[:, :, yy:yy + oy * sy:sy, xx:xx + ox * sx:sx] += np.einsum(
                    "nohw,oc->nchw", og, w[:, :, yy, xx], optimize=True)
        dx = dxp[:, :, py:py + H, px:px + W]
        db = og.sum(axis=(0, 2, 3))
        return (dx.astype(np.float32), dw.astype(np.float32), db.astype(np.float32))


@template
class Spreading(KernelTemplate):
    """Max-pool backward (reference: Spreading.cucl): spread out_grad back
    to the argmax input positions of each pooling window."""

    name = "Spreading"
    args = [adecl("in", IN, "img chan y x"),
            adecl("out", IN, "img chan y x"),
            adecl("out_grad", IN, "img chan y x"),
            adecl("in_grad", OUT, "img chan y x")]
    sig_nda_keys = ["kern_sz", "stride", "in_pad"]
    sig_str_keys = ["avg_pool"]

    @classmethod
    def build(cls, rfs: OpBase):
        import jax
        from .pool import Pool
        pool_fn = Pool.build(rfs)

        def fn(x, _out, og):
            _y, vjp = jax.vjp(pool_fn, x)
            (dx,) = vjp(og)
            return dx.astype(x.dtype)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, out, og):
        from .pool import _params
        ind, outd, ky, kx, sy, sx, py, px, avg = _params(rfs)
        x = np.asarray(x, np.float64)
        out = np.asarray(out, np.float64)
        og = np.asarray(og, np.float64)
        n, c, H, W = x.shape
        oy, ox = og.shape[2], og.shape[3]
        dx = np.zeros_like(x)
        for yy in range(oy):
            for xx in range(ox):
                y0, x0 = yy * sy - py, xx * sx - px
                y1, x1 = min(y0 + ky, H), min(x0 + kx, W)
                y0c, x0c = max(y0, 0), max(x0, 0)
                if avg:
                    cnt = (min(y0 + ky, H + py) - y0) * (min(x0 + kx, W + px) - x0)
                    dx[:, :, y0c:y1, x0c:x1] += og[:, :, yy:yy + 1, xx:xx + 1] / cnt
                else:
                    win = x[:, :, y0c:y1, x0c:x1]
                    # caffe-style: gradient goes to positions equal to the max
                    mask = win == out[:, :, yy:yy + 1, xx:xx + 1]
                    dx[:, :, y0c:y1, x0c:x1] += mask * og[:, :, yy:yy + 1, xx:xx + 1]
        return dx.astype(np.float32)


@template
class BckLrn(KernelTemplate):
    name = "bck_lrn"
    args = [adecl("in", IN, "img chan y x"),
            adecl("out_grad", IN, "img chan y x"),
            adecl("in_grad", OUT, "img chan y x")]
    sig_nda_keys = ["local_size", "alpha", "beta", "k"]

    @classmethod
    def build(cls, rfs: OpBase):
        import jax
        from .lrn import Lrn
        lrn_fn = Lrn.build(rfs)

        def fn(x, og):
            _y, vjp = jax.vjp(lrn_fn, x)
            (dx,) = vjp(og)
            return dx.astype(x.dtype)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, og):
        # numerical-gradient-free closed form is long; use the same windowed
        # formula caffe uses, derived independently of the jax vjp path.
        from .lrn import _params
        n_, alpha, beta, k = _params(rfs)
        x = np.asarray(x, np.float64)
        og = np.asarray(og, np.float64)
        C = x.shape[1]
        pre = n_ // 2
        sq = x * x
        scale = np.empty_like(x)
        for c in range(C):
            c0, c1 = max(0, c - pre), min(C, c - pre + n_)
            scale[:, c] = k + (alpha / n_) * sq[:, c0:c1].sum(axis=1)
        # d out_c / d in_c' = δ(c,c') s_c^-β - 2αβ/n · x_c x_c' s_c^(-β-1) [c' in win(c)]
        ratio = og * x * np.power(scale, -beta - 1.0)
        dx = og * np.power(scale, -beta)
        acc = np.zeros_like(x)
        for c in range(C):
            c0, c1 = max(0, c - pre), min(C, c - pre + n_)
            acc[:, c0:c1] += ratio[:, c:c + 1]
        dx -= (2.0 * alpha * beta / n_) * x * acc
        return dx.astype(np.float32)
