"""Pooling kernel template (reference: pool.cucl, rtc_fwd.cc:295-304).

Max / average pooling over NCHW with padding and stride from the op sig;
caffe semantics: ceil-mode output sizing, average pooling normalizes by the
*clipped* window size (border windows divide by their in-bounds count),
matching conv_util.cc pooling shape/semantics which the golden tests pin.
Optionally emits the argmax mask needed by the Spreading backward op.
"""

from __future__ import annotations

import numpy as np

from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template


def _max_pool_first_match(fn, ind, oy, ox, ky, kx, sy, sx, py, px,
                          extra_y, extra_x, nhwc: bool):
    """Wrap a max-pool primal `fn` with a gather-form custom VJP.

    Motivation: XLA's native max-pool transpose is SelectAndScatter, a
    scatter. This VJP computes the same gradient with no scatters: per window, the
    FIRST (row-major window-scan) position equal to the max gets the
    cotangent — caffe max-pool backward semantics (one winner per window,
    first argmax; reference pooling backward in cnn_codegen's Spreading
    kernels) and XLA SelectAndScatter's GE-select tie-break.
    Implementation: compute the first-match offset index per window (min
    matching offset), then gather each input position's covering-window
    contributions from stride-dilated (lax.pad interior) cotangent/index
    arrays — k*k fused elementwise terms, stride-1 slices only.

    The k*k full-size elementwise passes can cost more than the scatter
    (not measured on the GPU), so the wrap is OPT-IN via the
    pool_bwd=gather annotation (OpTune pool_bwd_gather); the default
    backward stays XLA's SelectAndScatter. Kept as a capability: the
    semantics pin (first-argmax == S&S GE-select, test_pool_grad.py)
    rides on it, and scatter-free backward matters on backends where
    scatter is the slow path (the interpret/CPU measurements).

    Only used for small windows (k*k <= 64): global max pooling would
    unroll k*k = y*x terms; its single-window backward is cheap under
    SelectAndScatter anyway.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    if ky * kx > 64:
        return fn
    # padded spatial extents the primal's jnp.pad produces
    yp = ind["y"] + 2 * py + extra_y
    xp_sz = ind["x"] + 2 * px + extra_x
    n_img, chans = ind["img"], ind["chan"]

    def _sp(y, x):  # (y, x) -> full index tuple for this layout
        return (0, y, x, 0) if nhwc else (0, 0, y, x)

    def _shape(y, x):
        return (n_img, y, x, chans) if nhwc else (n_img, chans, y, x)

    neg = -jnp.inf

    def _pad_in(xv):
        cfg = ((0, 0), (py, py + extra_y), (px, px + extra_x), (0, 0)) \
            if nhwc else \
            ((0, 0), (0, 0), (py, py + extra_y), (px, px + extra_x))
        return jnp.pad(xv, cfg, constant_values=neg)

    def _windows_max(xpad):
        win = (1, ky, kx, 1) if nhwc else (1, 1, ky, kx)
        st = (1, sy, sx, 1) if nhwc else (1, 1, sy, sx)
        m = lax.reduce_window(xpad, neg, lax.max, win, st, "valid")
        return m[:, :oy, :ox, :] if nhwc else m[:, :, :oy, :ox]

    offs = [(dy, dx) for dy in range(ky) for dx in range(kx)]

    @jax.custom_vjp
    def pool(xv):
        return fn(xv)

    def _fwd(xv):
        out = fn(xv)
        return out, (xv, out)

    def _bwd(res, g):
        xv, m = res
        xpad = _pad_in(xv)
        # first-match offset per window: min offset index whose strided
        # slice equals the window max (>=1 match always exists — all-pad
        # windows match at pad positions, trimmed below)
        fm = jnp.full(m.shape, len(offs), jnp.int32)
        strides = (1, sy, sx, 1) if nhwc else (1, 1, sy, sx)
        for idx, (dy, dx) in enumerate(offs):
            xs = lax.slice(xpad, _sp(dy, dx),
                           _shape(dy + (oy - 1) * sy + 1,
                                  dx + (ox - 1) * sx + 1),
                           strides)
            fm = jnp.minimum(fm, jnp.where(xs == m, idx, len(offs)))
        # stride-dilate g/fm (interior pad sy-1/sx-1), pre-pad k-1 both
        # sides so every input position reads its covering windows with
        # stride-1 slices; hi pad reaches padded-input extent
        dil_y = (oy - 1) * sy + 1
        dil_x = (ox - 1) * sx + 1
        hi_y = yp - dil_y
        hi_x = xp_sz - dil_x
        if nhwc:
            cfg = ((0, 0, 0), (ky - 1, hi_y, sy - 1),
                   (kx - 1, hi_x, sx - 1), (0, 0, 0))
        else:
            cfg = ((0, 0, 0), (0, 0, 0), (ky - 1, hi_y, sy - 1),
                   (kx - 1, hi_x, sx - 1))
        gd = lax.pad(g, jnp.asarray(0, g.dtype), cfg)
        fmd = lax.pad(fm, jnp.int32(-1), cfg)
        acc = jnp.zeros(_shape(yp, xp_sz), g.dtype)
        for idx, (dy, dx) in enumerate(offs):
            st = _sp(ky - 1 - dy, kx - 1 - dx)
            lim = tuple(s + d for s, d in zip(st, _shape(yp, xp_sz)))
            fs = lax.slice(fmd, st, lim)
            gs = lax.slice(gd, st, lim)
            acc = acc + jnp.where(fs == idx, gs, jnp.asarray(0, g.dtype))
        if nhwc:
            acc = acc[:, py:py + ind["y"], px:px + ind["x"], :]
        else:
            acc = acc[:, :, py:py + ind["y"], px:px + ind["x"]]
        return (acc,)

    pool.defvjp(_fwd, _bwd)
    return pool


def _params(rfs: OpBase):
    ind = rfs.get_dims("in")
    outd = rfs.get_dims("out")
    ks = rfs.get_dims_or_none("kern_sz")
    st = rfs.get_dims_or_none("stride")
    pad = rfs.get_dims_or_none("in_pad")
    ky, kx = (ks["y"], ks["x"]) if ks else (ind["y"], ind["x"])
    if ky == 0 or kx == 0:  # global pooling: kernel covers the whole input
        ky, kx = ind["y"], ind["x"]
    sy, sx = (st["y"], st["x"]) if st else (1, 1)
    py, px = (pad["y"], pad["x"]) if pad else (0, 0)
    avg = rfs.str_vals.get("avg_pool", "0") == "1"
    return ind, outd, ky, kx, sy, sx, py, px, avg


@template
class Pool(KernelTemplate):
    name = "pool"
    args = [adecl("in", IN, "img chan y x"), adecl("out", OUT, "img chan y x")]
    sig_nda_keys = ["kern_sz", "stride", "in_pad"]
    sig_str_keys = ["avg_pool", "layout", "pool_bwd"]
    nhwc_ok = True

    @classmethod
    def build(cls, rfs: OpBase):
        import jax
        import jax.numpy as jnp
        ind, outd, ky, kx, sy, sx, py, px, avg = _params(rfs)
        if rfs.str_vals.get("io_layout") == "nhwc":
            # storage-NHWC: input/output are NHWC tensors — no wrappers.
            # avg pooling accumulates in f32 (bf16 window sums lose bits),
            # output returns in the input's (edge) dtype.
            inner = cls._build_nhwc(rfs)

            def fn_store(xh):
                return inner(xh.astype(jnp.float32)).astype(xh.dtype) \
                    if avg else inner(xh)
            return fn_store
        if rfs.str_vals.get("layout") == "nhwc":
            # feature-minor windowing; wrapping transposes cancel against
            # the adjacent NHWC convs inside the fused program
            inner = cls._build_nhwc(rfs)

            def fn_nhwc(x):
                xh = jnp.transpose(x, (0, 2, 3, 1))
                return jnp.transpose(inner(xh), (0, 3, 1, 2))
            return fn_nhwc
        oy, ox = outd["y"], outd["x"]
        # pad enough for ceil-mode windows that extend past the padded edge
        need_y = (oy - 1) * sy + ky
        need_x = (ox - 1) * sx + kx
        extra_y = max(0, need_y - (ind["y"] + 2 * py))
        extra_x = max(0, need_x - (ind["x"] + 2 * px))

        if avg:
            # caffe divisor: window clipped to the *padded* image at the high
            # edge only (pooling_layer semantics) — precompute per (oy,ox)
            H, W = ind["y"], ind["x"]
            cy = np.array([min(yy * sy - py + ky, H + py) - (yy * sy - py) for yy in range(oy)])
            cx = np.array([min(xx * sx - px + kx, W + px) - (xx * sx - px) for xx in range(ox)])
            cnt = np.maximum(cy[:, None] * cx[None, :], 1).astype(ind.dtype)

            def fn(x):
                xp = jnp.pad(x, ((0, 0), (0, 0), (py, py + extra_y), (px, px + extra_x)))
                s = jax.lax.reduce_window(xp, 0.0, jax.lax.add, (1, 1, ky, kx),
                                          (1, 1, sy, sx), "valid")
                return s[:, :, :oy, :ox] / jnp.asarray(cnt)[None, None]
        else:
            def fn(x):
                # -inf init (not finfo.min): required for jax to recognize
                # the differentiable reduce_window_max form
                neg = -jnp.inf
                xp = jnp.pad(x, ((0, 0), (0, 0), (py, py + extra_y), (px, px + extra_x)),
                             constant_values=neg)
                m = jax.lax.reduce_window(xp, neg, jax.lax.max, (1, 1, ky, kx),
                                          (1, 1, sy, sx), "valid")
                return m[:, :, :oy, :ox]
            if rfs.str_vals.get("pool_bwd") == "gather":
                fn = _max_pool_first_match(fn, ind, oy, ox, ky, kx, sy, sx,
                                           py, px, extra_y, extra_x,
                                           nhwc=False)
        return fn

    @classmethod
    def _build_nhwc(cls, rfs: OpBase):
        import jax
        import jax.numpy as jnp
        ind, outd, ky, kx, sy, sx, py, px, avg = _params(rfs)
        oy, ox = outd["y"], outd["x"]
        need_y = (oy - 1) * sy + ky
        need_x = (ox - 1) * sx + kx
        extra_y = max(0, need_y - (ind["y"] + 2 * py))
        extra_x = max(0, need_x - (ind["x"] + 2 * px))
        if avg:
            H, W = ind["y"], ind["x"]
            cy = np.array([min(yy * sy - py + ky, H + py) - (yy * sy - py) for yy in range(oy)])
            cx = np.array([min(xx * sx - px + kx, W + px) - (xx * sx - px) for xx in range(ox)])
            cnt = np.maximum(cy[:, None] * cx[None, :], 1).astype(ind.dtype)

            def fn(xh):
                xp = jnp.pad(xh, ((0, 0), (py, py + extra_y), (px, px + extra_x), (0, 0)))
                s = jax.lax.reduce_window(xp, 0.0, jax.lax.add, (1, ky, kx, 1),
                                          (1, sy, sx, 1), "valid")
                return s[:, :oy, :ox, :] / jnp.asarray(cnt)[None, :, :, None]
        else:
            def fn(xh):
                neg = -jnp.inf
                xp = jnp.pad(xh, ((0, 0), (py, py + extra_y), (px, px + extra_x), (0, 0)),
                             constant_values=neg)
                m = jax.lax.reduce_window(xp, neg, jax.lax.max, (1, ky, kx, 1),
                                          (1, sy, sx, 1), "valid")
                return m[:, :oy, :ox, :]
            if rfs.str_vals.get("pool_bwd") == "gather":
                fn = _max_pool_first_match(fn, ind, oy, ox, ky, kx, sy, sx,
                                           py, px, extra_y, extra_x,
                                           nhwc=True)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        ind, outd, ky, kx, sy, sx, py, px, avg = _params(rfs)
        x = np.asarray(x)
        n, c, H, W = x.shape
        oy, ox = outd["y"], outd["x"]
        out = np.zeros((n, c, oy, ox), dtype=x.dtype)
        for yy in range(oy):
            for xx in range(ox):
                y0, x0 = yy * sy - py, xx * sx - px
                y1, x1 = min(y0 + ky, H), min(x0 + kx, W)
                y0c, x0c = max(y0, 0), max(x0, 0)
                win = x[:, :, y0c:y1, x0c:x1]
                if avg:
                    # caffe: divide by clipped-to-padded-image window size
                    cnt = (min(y0 + ky, H + py) - y0) * (min(x0 + kx, W + px) - x0)
                    out[:, :, yy, xx] = win.sum(axis=(2, 3)) / max(cnt, 1)
                else:
                    out[:, :, yy, xx] = win.max(axis=(2, 3)) if win.size else 0
        return out
