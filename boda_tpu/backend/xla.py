"""XLA backend: JAX on the GPU (or CPU) — the nvrtc backend's analog.

Capability parity with nvrtc_compute_t (nvrtc_util.cc:174): device context
init, AOT batch compilation of generated functions (nvrtcCompile→module load
becomes jit→lower→compile against fixed shapes), named device vars in HBM,
per-call timing, optional generated-source dump (here: StableHLO text), and
get_plat_tag() = platform + device kind, used as the wisdom/tuning key
(nvrtc_util.cc:206-214).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.config import Attr, register
from ..core.dims import Dims
from ..core.error import RtErr
from .iface import Backend, CompiledFunc


# fixed in-checkout path (listed in .gitignore): the cache key includes
# the directory, so a path that moves between runs never hits
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory
    ('' when off). Idempotent.

    JAX_COMPILATION_CACHE_DIR, when set, is used as is (JAX reads it
    itself) and no other directory is set. Otherwise the cache goes to
    CACHE_DIR whenever the backend is `gpu`: a whole-net ResNet-50
    program takes seconds to compile there. XLA:CPU programs are not
    cached (cheap to compile, and their entries are tied to the host's
    CPU features)."""
    import os

    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.default_backend() != "gpu":
        return ""
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


@register(Backend, "xla", help="JAX/XLA backend (GPU or CPU)")
class XlaBackend(Backend):
    kind = "xla"
    device_ordinal = Attr(int, default=0, help="jax device index to use")
    platform = Attr(str, default="", help="force jax platform (gpu/cpu); default auto")

    def init(self) -> None:
        import jax
        plat = self.platform
        devs = jax.devices(plat) if plat else jax.devices()
        enable_compilation_cache()
        if self.device_ordinal >= len(devs):
            raise RtErr(f"device ordinal {self.device_ordinal} out of range "
                        f"({len(devs)} devices)")
        self._device = devs[self.device_ordinal]
        self._jax = jax
        self._initialized = True

    def get_plat_tag(self) -> str:
        self.ensure_init()
        return f"xla:{self._device.platform}:{self._device.device_kind}"

    # ---- impl hooks ----
    def _alloc(self, dims: Dims):
        import jax.numpy as jnp
        dt = dims.dtype
        if dt is None:
            raise RtErr(f"can't allocate var with tn=none dims {dims}")
        with self._jax.default_device(self._device):
            return jnp.zeros(dims.shape, dtype=dt)

    def _to_device(self, v):
        return self._jax.device_put(np.asarray(v), self._device)

    def _to_host(self, v):
        return np.asarray(v)

    def _block_on(self, outs) -> None:
        for o in outs:
            if hasattr(o, "block_until_ready"):
                o.block_until_ready()

    def _compile_one(self, f: CompiledFunc) -> None:
        jax = self._jax
        specs = [jax.ShapeDtypeStruct(d.shape, d.dtype) for _n, d in f.in_specs]
        jitted = jax.jit(f.fn)
        try:
            # pin lowering to this backend's device (device_ordinal)
            with jax.default_device(self._device):
                lowered = jitted.lower(*specs)
        except Exception as e:
            raise RtErr(f"compile of '{f.name}' failed at lowering: {e}") from e
        if self.gen_src:
            p = Path(self.gen_src_output_dir)
            p.mkdir(parents=True, exist_ok=True)
            (p / f"{f.name}.stablehlo.txt").write_text(lowered.as_text())
        try:
            compiled = lowered.compile()
        except Exception as e:
            raise RtErr(f"compile of '{f.name}' failed: {e}") from e
        f.fn = compiled

    def profile_start(self) -> None:
        import jax
        self._trace_dir = Path(self.gen_src_output_dir) / "jax_trace"
        jax.profiler.start_trace(str(self._trace_dir))

    def profile_stop(self) -> None:
        import jax
        jax.profiler.stop_trace()
