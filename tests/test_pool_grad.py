"""Max-pool backward (ops/pallas/pool._max_pool_first_match).

XLA's native max-pool transpose is SelectAndScatter, a scatter, so the
pool template carries an alternative gather-form custom VJP. It is
OPT-IN via the
pool_bwd=gather annotation (OpTune pool_bwd_gather) and the default
backward stays SelectAndScatter. These tests pin:

(1) the primal is unchanged (template fwd still matches ref_impl —
    covered by the existing op/golden suites; re-asserted here),
(2) the custom grad equals JAX's own select-and-scatter grad on
    tie-free data, for both NCHW and storage-NHWC forms across
    geometries (resnet pool1 ceil-mode class, s1 pad, k=s),
(3) on TIE-HEAVY data the grad matches an independent numpy reference
    of caffe first-argmax semantics (one winner per window, row-major
    scan — reference pooling backward: Spreading kernels,
    cnn_codegen.cc; pooling_layer.cpp backward),
(4) the global-pooling form (k*k > 64 fallback) still differentiates.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from boda_tpu.core.dims import Dims  # noqa: E402
from boda_tpu.graph.support import Pt, pool_in_sz_to_out_sz  # noqa: E402
from boda_tpu.ops.op_base import OpBase  # noqa: E402
from boda_tpu.ops.registry import get_template  # noqa: E402


def make_pool_op(n, c, h, w, ky, kx, sy=1, sx=1, py=0, px=0, avg=False,
                 io_layout="", pool_bwd="gather"):
    out = pool_in_sz_to_out_sz(Pt(w, h), Pt(px, py), Pt(sx, sy), Pt(kx, ky))
    op = OpBase({"type": "Pooling", "func_name": "pool"})
    op.set_dims("in", Dims.make(img=n, chan=c, y=h, x=w))
    op.set_dims("out", Dims.make(img=n, chan=c, y=out.y, x=out.x))
    op.set_null_dims("kern_sz", y=ky, x=kx)
    op.set_null_dims("stride", y=sy, x=sx)
    op.set_null_dims("in_pad", y=py, x=px)
    if avg:
        op.str_vals["avg_pool"] = "1"
    if io_layout:
        op.str_vals["io_layout"] = io_layout
    if pool_bwd:  # these tests pin the (opt-in) gather form by default
        op.str_vals["pool_bwd"] = pool_bwd
    return op


def _build(op):
    tmpl = get_template("pool")
    rfs = tmpl.check_args(op)
    return tmpl, rfs, tmpl.build(rfs)


def _native_max_pool(ky, kx, sy, sx, py, px, oy, ox, h, w, nhwc):
    """The same pool geometry WITHOUT the custom VJP — jax differentiates
    it via select-and-scatter (the behavior we claim to reproduce)."""
    need_y, need_x = (oy - 1) * sy + ky, (ox - 1) * sx + kx
    ey = max(0, need_y - (h + 2 * py))
    ex = max(0, need_x - (w + 2 * px))
    neg = -jnp.inf

    def fn(x):
        if nhwc:
            xp = jnp.pad(x, ((0, 0), (py, py + ey), (px, px + ex), (0, 0)),
                         constant_values=neg)
            m = lax.reduce_window(xp, neg, lax.max, (1, ky, kx, 1),
                                  (1, sy, sx, 1), "valid")
            return m[:, :oy, :ox, :]
        xp = jnp.pad(x, ((0, 0), (0, 0), (py, py + ey), (px, px + ex)),
                     constant_values=neg)
        m = lax.reduce_window(xp, neg, lax.max, (1, 1, ky, kx),
                              (1, 1, sy, sx), "valid")
        return m[:, :, :oy, :ox]
    return fn


def np_first_argmax_pool_bwd(x, g, ky, kx, sy, sx, py, px):
    """Independent reference: caffe max-pool backward — each window sends
    its cotangent to the FIRST (row-major in-window scan) position that
    attains the window max; out-of-bounds positions never win."""
    n, c, H, W = x.shape
    oy, ox = g.shape[2], g.shape[3]
    gx = np.zeros_like(x, dtype=np.float64)
    for yy in range(oy):
        for xx in range(ox):
            y0, x0 = yy * sy - py, xx * sx - px
            best, bq = -np.inf * np.ones((n, c)), None
            bq = np.zeros((n, c, 2), np.int64)
            found = np.zeros((n, c), bool)
            for dy in range(ky):
                for dx in range(kx):
                    q = (y0 + dy, x0 + dx)
                    if not (0 <= q[0] < H and 0 <= q[1] < W):
                        continue
                    v = x[:, :, q[0], q[1]]
                    take = v > best
                    best = np.where(take, v, best)
                    bq[..., 0] = np.where(take, q[0], bq[..., 0])
                    bq[..., 1] = np.where(take, q[1], bq[..., 1])
                    found |= take
            if not found.any():
                continue
            for i in range(n):
                for j in range(c):
                    if found[i, j]:
                        gx[i, j, bq[i, j, 0], bq[i, j, 1]] += g[i, j, yy, xx]
    return gx


GEOMS = [
    # (h, w, ky, kx, sy, sx, py, px) — resnet pool1 ceil-mode class,
    # stride-1 padded, k==s (non-overlapping), asymmetric kernel
    (12, 12, 3, 3, 2, 2, 0, 0),
    (9, 9, 3, 3, 1, 1, 1, 1),
    (8, 8, 2, 2, 2, 2, 0, 0),
    (10, 8, 3, 2, 2, 2, 1, 0),
]


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("io_layout", ["", "nhwc"])
def test_max_pool_grad_matches_select_and_scatter(geom, io_layout):
    h, w, ky, kx, sy, sx, py, px = geom
    n, c = 2, 8
    op = make_pool_op(n, c, h, w, ky, kx, sy, sx, py, px,
                      io_layout=io_layout)
    _t, rfs, fn = _build(op)
    oy, ox = rfs.get_dims("out")["y"], rfs.get_dims("out")["x"]
    rng = np.random.RandomState(0)
    nhwc = io_layout == "nhwc"
    shape = (n, h, w, c) if nhwc else (n, c, h, w)
    x = rng.randn(*shape).astype(np.float32)  # continuous: ties measure-0
    gshape = (n, oy, ox, c) if nhwc else (n, c, oy, ox)
    ct = rng.randn(*gshape).astype(np.float32)

    def loss(fnc):
        return lambda xv: jnp.sum(fnc(xv) * ct)

    got = jax.grad(loss(fn))(x)
    native = _native_max_pool(ky, kx, sy, sx, py, px, oy, ox, h, w, nhwc)
    want = jax.grad(loss(native))(x)
    # overlapping windows sum their contributions in a different order
    # than select-and-scatter — f32 add-order noise only
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-7)
    # primal unchanged
    np.testing.assert_allclose(np.asarray(fn(x)), np.asarray(native(x)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("geom", GEOMS)
def test_max_pool_grad_tie_heavy_first_argmax(geom):
    h, w, ky, kx, sy, sx, py, px = geom
    n, c = 2, 4
    op = make_pool_op(n, c, h, w, ky, kx, sy, sx, py, px)
    _t, _rfs, fn = _build(op)
    rng = np.random.RandomState(1)
    # post-relu-like: ~60% exact zeros + a few quantized levels — many
    # windows have tied maxima, exercising the first-match tie-break
    x = np.maximum(rng.randint(-2, 3, size=(n, c, h, w)), 0) \
        .astype(np.float32) * 0.5
    oy = np.asarray(fn(x)).shape[2]
    ox = np.asarray(fn(x)).shape[3]
    ct = rng.randn(n, c, oy, ox).astype(np.float32)
    got = jax.grad(lambda xv: jnp.sum(fn(xv) * ct))(x)
    want = np_first_argmax_pool_bwd(x, ct, ky, kx, sy, sx, py, px)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


def test_global_max_pool_still_differentiates():
    # k*k > 64 -> the custom VJP steps aside; grad must still flow
    op = make_pool_op(1, 4, 10, 10, 10, 10, 1, 1, 0, 0)
    _t, _rfs, fn = _build(op)
    x = np.random.RandomState(2).randn(1, 4, 10, 10).astype(np.float32)
    g = jax.grad(lambda xv: jnp.sum(fn(xv)))(x)
    assert np.asarray(g).sum() == pytest.approx(4.0)  # one winner per chan


def test_default_pool_bwd_is_select_and_scatter_and_agrees():
    # without the pool_bwd=gather annotation the template differentiates
    # via XLA's SelectAndScatter; on tie-heavy data its grad must equal
    # the first-argmax semantics the gather form pins (GE-select picks
    # the first max in scan order too)
    h, w, ky, kx, sy, sx, py, px = GEOMS[0]
    n, c = 2, 4
    op = make_pool_op(n, c, h, w, ky, kx, sy, sx, py, px, pool_bwd="")
    assert "pool_bwd" not in op.str_vals
    _t, _rfs, fn = _build(op)
    rng = np.random.RandomState(4)
    x = np.maximum(rng.randint(-2, 3, size=(n, c, h, w)), 0) \
        .astype(np.float32) * 0.5
    out = np.asarray(fn(x))
    ct = rng.randn(n, c, out.shape[2], out.shape[3]).astype(np.float32)
    got = jax.grad(lambda xv: jnp.sum(fn(xv) * ct))(x)
    want = np_first_argmax_pool_bwd(x, ct, ky, kx, sy, sx, py, px)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


def test_avg_pool_grad_unaffected():
    op = make_pool_op(2, 4, 8, 8, 2, 2, 2, 2, 0, 0, avg=True)
    _t, _rfs, fn = _build(op)
    x = np.random.RandomState(3).randn(2, 4, 8, 8).astype(np.float32)
    g = jax.grad(lambda xv: jnp.sum(fn(xv)))(x)
    np.testing.assert_allclose(np.asarray(g), np.full_like(x, 0.25))
