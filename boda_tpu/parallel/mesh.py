"""Device-mesh parallelism: the answer to SURVEY.md §2.8.

The reference is single-device (one rtc_compute_t; its only distribution is
the host-RPC `ipc` backend, rtc_ipc.cc). This build scales the same
workloads over a jax.sharding.Mesh instead:

  * data parallel  — the `img` named dim shards over the 'dp' mesh axis,
  * tensor/model parallel — conv/fc filter `out_chan` (and the produced
    activation `chan`) shard over 'mp'; XLA GSPMD propagates the shardings
    and inserts the all-gathers/psums over ICI,
  * named dims → PartitionSpec is a pure table lookup, which is exactly why
    the named-dims design was kept (SURVEY.md §2.1 boda_base notes).

Collectives are never hand-written here; lay out shardings, jit, and let
XLA place psum/all-gather on ICI (scaling-book recipe).
"""

from __future__ import annotations

from typing import Optional

from ..core.error import RtErr

# named dim → mesh axis mapping for activations/weights
_DIM_TO_AXIS = {
    "img": "dp",
    "out_chan": "mp",
}


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              mp: int = 1, devices=None):
    """Build a 2-D ('dp','mp') mesh over the available devices."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if dp is None:
        if n % mp:
            raise RtErr(f"mesh: {n} devices not divisible by mp={mp}")
        dp = n // mp
    if dp * mp != n:
        raise RtErr(f"mesh: dp*mp = {dp}*{mp} != {n} devices")
    arr = np.array(devices).reshape(dp, mp)
    return Mesh(arr, ("dp", "mp"))


def spec_for_dims(dims, mesh, shard_weights: bool = True):
    """PartitionSpec for a named-dims tensor: img→dp; out_chan→mp (weights,
    when divisible); everything else replicated."""
    from jax.sharding import PartitionSpec as P
    axes = []
    used = set()
    for d in dims:
        ax = _DIM_TO_AXIS.get(d.name)
        if ax is None or ax in used:
            axes.append(None)
            continue
        size = dict(zip(("dp", "mp"), mesh.devices.shape))[ax]
        if ax == "mp" and not shard_weights:
            axes.append(None)
            continue
        if size > 1 and d.sz % size == 0:
            axes.append(ax)
            used.add(ax)
        else:
            axes.append(None)
    while axes and axes[-1] is None:
        axes.pop()
    return P(*axes)


def plan_shardings(plan, mesh, shard_weights: bool = True):
    """Shardings for a lowered Plan's inputs and weights (dicts of
    NamedSharding keyed like the fused fn's arguments)."""
    from jax.sharding import NamedSharding
    in_sh = {n: NamedSharding(mesh, spec_for_dims(plan.node_dims[n], mesh,
                                                  shard_weights=False))
             for n in plan.input_nodes}
    w_sh = {n: NamedSharding(mesh, spec_for_dims(plan.node_dims[n], mesh,
                                                 shard_weights=shard_weights))
            for n in plan.weight_nodes}
    return in_sh, w_sh
