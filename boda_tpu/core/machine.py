"""Single source of truth for the device machine model: published peaks.

The reference hardcoded its machine model in one place per tool
(peak_flops=6600e9 in cnn-prof.cc:36, --peak-flops overrides for other
devices, doc/sgemm-notes.txt:54). Here one table, keyed by jax's
`device_kind`, holds the vendor's published peaks; every consumer
(bench.py, cnet_bench, cnn_op_info, roofline_plot) reads from it. A
device that is not in the table is an error, never a default: a roofline
share against a made-up peak is fiction. Modes that take explicit
`peak_flops`/`hbm_gbps` still accept them (that is how the CPU goldens
run).

Source of every row: NVIDIA H100 Tensor Core GPU datasheet, SXM5 part,
dense rates (without sparsity), at the full 700 W power limit. A card
set below that limit cannot hold its top clock under matrix-heavy load,
so report `nvidia-smi` power.limit beside any share taken against these.
"""

from __future__ import annotations

from dataclasses import dataclass

from .error import RtErr


@dataclass(frozen=True)
class DevicePeaks:
    device_kind: str
    flops: dict[str, float]   # compute precision -> peak [FLOP/s or OP/s]
    hbm_bw: float             # device-memory bandwidth [B/s]
    hbm_bytes: float          # device-memory capacity [B]
    source: str


_H100_SXM = DevicePeaks(
    device_kind="NVIDIA H100 80GB HBM3",
    flops={"bf16": 989e12, "f16": 989e12, "fp8": 1979e12, "int8": 1979e12,
           "tf32": 495e12, "f32": 67e12},
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    source="NVIDIA H100 Tensor Core GPU datasheet (SXM5, dense)")

_TABLE: dict[str, DevicePeaks] = {_H100_SXM.device_kind: _H100_SXM}


def device_peaks(device_kind: str) -> DevicePeaks:
    p = _TABLE.get(device_kind)
    if p is None:
        raise RtErr(f"no published peaks for device kind '{device_kind}' "
                    f"(known: {sorted(_TABLE)}); pass peak_flops/hbm_gbps "
                    f"explicitly where the mode takes them")
    return p


def peak_flops(device_kind: str, prec: str = "bf16") -> float:
    pk = device_peaks(device_kind).flops
    if prec not in pk:
        raise RtErr(f"no published '{prec}' peak for '{device_kind}' "
                    f"(known: {sorted(pk)})")
    return pk[prec]


def hbm_bw(device_kind: str) -> float:
    return device_peaks(device_kind).hbm_bw


def current_device_kind() -> str:
    import jax
    return jax.devices()[0].device_kind


def gpu_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of each card, as it prints
    them; what to write beside every number taken on the card."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip() or r.stderr.strip()
