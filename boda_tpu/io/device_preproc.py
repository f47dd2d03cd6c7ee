"""Device-side batched image preprocessing with host→HBM prefetch.

BASELINE.json north star: "image preprocessing — decode, resize, and
pyramid packing — fuses into device-side batched transforms with
host→HBM prefetch". Decode stays host-side (PIL); everything after the
raw uint8 image — resize, RGB→BGR, mean-subtract, HWC→CHW — runs as one
jitted XLA program on device, and `PrefetchFeeder` overlaps the next
batch's H2D transfer with the current batch's compute (jax transfers are
async; dispatch-before-use gives the overlap).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ..core.dims import NDA, Dims
from .img import DEFAULT_MEAN_BGR


def device_preproc_fn(out_y: int, out_x: int, bgr: bool = True,
                      mean: Optional[tuple] = DEFAULT_MEAN_BGR,
                      dtype="float32"):
    """Traceable (un-jitted) (B,y,x,3) uint8 → (B,3,out_y,out_x) float
    transform, for composition INTO a larger jitted program (engine
    `set_input_preproc`: the u8 serving wire format fuses this with the
    net forward — one dispatch, 4x smaller upload than f32)."""
    import jax
    import jax.numpy as jnp

    def preproc(imgs):
        mean_v = None if mean is None else jnp.asarray(mean, jnp.float32)
        x = imgs.astype(jnp.float32)
        b, h, w, _c = x.shape
        if (h, w) != (out_y, out_x):
            x = jax.image.resize(x, (b, out_y, out_x, 3), method="bilinear")
        if bgr:
            x = x[..., ::-1]
        if mean_v is not None:
            x = x - mean_v
        return jnp.transpose(x, (0, 3, 1, 2)).astype(dtype)

    return preproc


def make_device_preproc(out_y: int, out_x: int, bgr: bool = True,
                        mean: Optional[tuple] = DEFAULT_MEAN_BGR,
                        dtype="float32"):
    """Jitted (B,y,x,3) uint8 → (B,3,out_y,out_x) float preprocessing."""
    import jax
    return jax.jit(device_preproc_fn(out_y, out_x, bgr=bgr, mean=mean,
                                     dtype=dtype))


def make_device_pyra_pack(pp, bgr: bool = True,
                          mean: Optional[tuple] = DEFAULT_MEAN_BGR,
                          dtype="float32"):
    """Device-side pyramid pack: (in_y,in_x,3) float frame (0-255 RGB) →
    (num_bins, 3, bin_y, bin_x) packed batch, entirely on device.

    Device-side counterpart of `ImgPyraPack.scale_and_pack_img_into_bins`
    (the host/PIL parity path, reference conv_pyra.cc:24 img_pyra_pack):
    the host uploads ONE raw frame (~1 MB) and every scale resample, edge
    pad, bin placement, BGR swap, and mean-subtract runs inside the XLA
    program — so it fuses with the net forward under one jit and the
    host does no per-scale resampling. All shapes/offsets are static (from
    the blf placement), so XLA sees pure pad/slice/update ops.

    Numerics match the host path's `packed → img_to_chw` composition:
    un-covered bin pixels come out as 0 - mean (host packs uint8 zeros
    then mean-subtracts); edge padding replicates the last row/col.
    Returns the raw traceable fn — callers jit or compose it."""
    import jax
    import jax.numpy as jnp

    mean_v = None if mean is None else jnp.asarray(mean, jnp.float32)
    bin_y, bin_x = pp.bin_sz.y, pp.bin_sz.x

    def pack(frame):
        x = frame.astype(jnp.float32)
        bins = [jnp.zeros((bin_y, bin_x, 3), jnp.float32)
                for _ in range(pp.num_bins)]
        for si in pp.scales:
            sy, sx = si.sz.y, si.sz.x
            sc = x if (sy, sx) == x.shape[:2] else \
                jax.image.resize(x, (sy, sx, 3), method="bilinear")
            b = si.place
            ey = min(b.p1.y + pp.pad.y, bin_y) - b.p1.y
            ex = min(b.p1.x + pp.pad.x, bin_x) - b.p1.x
            if ey or ex:
                sc = jnp.pad(sc, ((0, ey), (0, ex), (0, 0)), mode="edge")
            bins[si.bin_ix] = jax.lax.dynamic_update_slice(
                bins[si.bin_ix], sc, (b.p0.y, b.p0.x, 0))
        out = jnp.stack(bins)
        if bgr:
            out = out[..., ::-1]
        if mean_v is not None:
            out = out - mean_v
        return jnp.transpose(out, (0, 3, 1, 2)).astype(dtype)

    return pack


class PrefetchFeeder:
    """Iterate preprocessed device batches with one-batch H2D prefetch.

    source: iterator of (B,y,x,3) uint8 numpy batches. The next batch is
    device_put (async) while the caller consumes the current one."""

    def __init__(self, source: Iterator[np.ndarray], out_y: int, out_x: int,
                 **preproc_kw):
        self._src = iter(source)
        self._preproc = make_device_preproc(out_y, out_x, **preproc_kw)
        self._pending = None

    def _stage(self):
        import jax
        try:
            host = next(self._src)
        except StopIteration:
            return None
        return self._preproc(jax.device_put(np.ascontiguousarray(host)))

    def __iter__(self):
        self._pending = self._stage()
        while self._pending is not None:
            cur = self._pending
            self._pending = self._stage()  # overlaps with consumer compute
            yield cur


def preprocess_batch_nda(imgs: np.ndarray, dims: Dims, bgr: bool = True,
                         mean: Optional[tuple] = DEFAULT_MEAN_BGR) -> NDA:
    """One-shot helper: uint8 (B,y,x,3) → NDA matching a net's data dims."""
    fn = make_device_preproc(dims["y"], dims["x"], bgr=bgr, mean=mean,
                             dtype=dims.dtype)
    return NDA(dims, np.asarray(fn(imgs)).reshape(dims.shape))
