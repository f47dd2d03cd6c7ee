"""Device machine model (published peaks), compile-cache placement, the
gpu feature probe, and roofline reporting on a device without peaks."""

import types

import pytest

from boda_tpu.core.error import RtErr
from boda_tpu.core.machine import (device_peaks, hbm_bw, peak_flops)

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("prec,want", [
    ("bf16", 989e12), ("f16", 989e12), ("fp8", 1979e12),
    ("int8", 1979e12), ("tf32", 495e12), ("f32", 67e12)])
def test_h100_published_peaks(prec, want):
    assert peak_flops(H100, prec) == want


def test_h100_memory_and_knee():
    p = device_peaks(H100)
    assert hbm_bw(H100) == 3.35e12 and p.hbm_bytes == 80e9
    assert "datasheet" in p.source
    # bf16 knee ~295 flop/byte: ops below it are bandwidth-bound
    assert 290 < p.flops["bf16"] / p.hbm_bw < 300


@pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite", "NVIDIA A100-SXM4-80GB",
                                  ""])
def test_unknown_device_raises(kind):
    with pytest.raises(RtErr, match="no published peaks"):
        peak_flops(kind, "bf16")


def test_unknown_precision_raises():
    with pytest.raises(RtErr, match="no published 'f64' peak"):
        peak_flops(H100, "f64")


def test_compile_cache_env_dir_wins(monkeypatch, tmp_path):
    import jax

    from boda_tpu.backend import xla
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert xla.enable_compilation_cache() == str(tmp_path)
    # the code sets no other directory: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_off_on_cpu(monkeypatch):
    from boda_tpu.backend import xla
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert xla.enable_compilation_cache() == ""


def test_compile_cache_in_checkout_on_gpu(monkeypatch):
    import jax

    from boda_tpu.backend import xla
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    old = jax.config.jax_compilation_cache_dir
    try:
        got = xla.enable_compilation_cache()
        assert got == str(xla.CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    # the fixed path sits inside the checkout and git ignores it
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    assert xla.CACHE_DIR.parent == root
    assert f"/{xla.CACHE_DIR.name}/" in (root / ".gitignore").read_text()


def test_gpu_feature_probe_false_on_cpu():
    from boda_tpu.core.features import enabled_features, is_feature_enabled
    assert is_feature_enabled("gpu") is False
    assert "gpu" not in enabled_features()
    assert "tpu" not in enabled_features()


def test_frac_roofline_names_no_share_on_cpu():
    from boda_tpu.apps.cnet_bench import frac_roofline
    cpu = types.SimpleNamespace(platform="cpu", device_kind="cpu")
    assert frac_roofline(1e12, cpu, "bf16") == "n/a"
    gpu = types.SimpleNamespace(platform="gpu", device_kind=H100)
    assert frac_roofline(989e12 / 2, gpu, "bf16") == "0.5000"
    odd = types.SimpleNamespace(platform="gpu", device_kind="unknown card")
    with pytest.raises(RtErr):
        frac_roofline(1e12, odd, "bf16")


def test_xprof_gpu_trace_without_device_events_raises(tmp_path):
    """On a gpu platform the host-plane fallback is an error."""
    import jax
    import jax.numpy as jnp

    from boda_tpu.tune.xprof import aggregate_xplane, find_xplane
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((32, 32))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    fn = find_xplane(tmp_path)
    rows, meta = aggregate_xplane(fn, "cpu")  # CPU: host-plane events
    assert rows and meta["device_planes"] == []
    with pytest.raises(RtErr, match="no device kernel events"):
        aggregate_xplane(fn, "gpu")


@pytest.mark.gpu
def test_gpu_backend_platform_and_peaks(gpu_device):
    """On a card: the xla backend tags the gpu platform, and the card's
    kind has published peaks (a missing row would fail every roofline)."""
    from boda_tpu.backend.iface import make_backend
    be = make_backend("xla")
    be.init()
    assert be.get_plat_tag().startswith("xla:gpu:")
    assert peak_flops(gpu_device.device_kind, "bf16") > 0
