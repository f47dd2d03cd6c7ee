"""Measured tuning presets (per-model selective-site tune sets).

The reference carried per-op tuning knowledge in wisdom files; net-level
selective-precision site sets have no reference analog (quantization
there was a per-layer fixed-point experiment, rtc_fwd.cc:28-37). The site
sets were chosen by sweeps on an earlier accelerator; on the GPU they are
not measured yet (PERF.md).
"""

from __future__ import annotations

import re

from ..ops.cnn_variants import OpTune, make_op_tune

# ResNet-family selective int8: the K=9C 3x3 contractions of stage 3 and
# every stage-4/5 conv (N>=256); stage-2 (Cm=64) and stage-3 1x1s stay
# bf16
RESNET_INT8_SITE_PATS = (r"res3[a-z0-9]*_branch2b",
                         r"res[45][a-z0-9]*_branch.*")

# TRAINING int8-wgrad site set: the 3x3 grad contractions of stages 3-5
# and the s5 1x1->2048 expansion — the quantize passes (full read+write
# of activation and cotangent) only amortize where the contraction has
# >=9 taps or >=2048-wide products.
RESNET_GRAD_Q8_SITE_PATS = (r"res[345][a-z0-9]*_branch2b",
                            r"res5[a-z0-9]*_branch2c")


def resnet_grad_q8_site_tunes(pipe, base_tune_spec: str) -> dict[str, OpTune]:
    """Tag→tune map applying int8 WEIGHT-GRADIENT convs (OpTune grad_q8)
    to the measured-winner training site set of a ResNet-family pipe."""
    assert base_tune_spec.endswith(")")
    q = make_op_tune(base_tune_spec[:-1] + ",grad_q8=1)")
    rxs = [re.compile(p) for p in RESNET_GRAD_Q8_SITE_PATS]
    return {op.tag: q for op in pipe.ops.values()
            if op.type == "Convolution"
            and any(rx.fullmatch(op.tag) for rx in rxs)}


def resnet_int8_site_tunes(pipe, base_tune_spec: str) -> dict[str, OpTune]:
    """Tag→tune map applying dynamic int8 to the measured-winner site set
    of a ResNet-family pipe (no-op: returns {} for other nets)."""
    assert base_tune_spec.endswith(")")
    q = make_op_tune(base_tune_spec[:-1] + ",quant8=1)")
    rxs = [re.compile(p) for p in RESNET_INT8_SITE_PATS]
    return {op.tag: q for op in pipe.ops.values()
            if op.type == "Convolution"
            and any(rx.fullmatch(op.tag) for rx in rxs)}


def calibrate_int8_act_scales(pipe, base_tune_spec: str, x,
                              site_tunes: dict[str, OpTune]) -> dict[str, OpTune]:
    """Static int8 calibration: run ONE float forward over calibration
    input x (logical NCHW), read each quantized site's INPUT-node absmax,
    and return per-site tunes carrying act_scale — the quant8 kernels
    then skip the per-call dynamic activation-max reduction. (The
    analog of the reference's per-layer max_val quantize spec,
    rtc_fwd.cc:28-37, which also took calibrated ranges from outside.)"""
    import copy

    import numpy as np

    from ..core.error import RtErr
    from ..engine.lower import lower_pipe, resolve_plan_weights
    from ..engine.rtc_fwd import build_fused_forward

    plan = lower_pipe(pipe, make_op_tune(base_tune_spec), fused_storage=True)
    fwd = build_fused_forward(plan, keep_all_nodes=True)
    weights = resolve_plan_weights(plan, pipe.op_params)
    data_node = pipe.data_img_node_names[0]
    vals = fwd({data_node: x}, weights)
    out = {}
    for tag, tune in site_tunes.items():
        op = pipe.get_op(tag)
        in_node = op.bots[0]
        if in_node not in vals:
            # guessing a scale (e.g. from the raw image) would silently
            # clip nearly everything — refuse instead
            raise RtErr(f"calibrate_int8_act_scales: input node '{in_node}'"
                        f" of site '{tag}' not in the forward's kept values"
                        " (calibrate with a base tune whose fusion passes"
                        " keep it)")
        v = np.asarray(vals[in_node])
        # OpTune objects are plain attrs — shallow-copy and set the scale
        t2 = copy.copy(tune)
        t2.act_scale = float(np.abs(v).max()) or 1e-6
        out[tag] = t2
    return out


def save_act_scales(path, tunes: dict[str, OpTune]) -> None:
    """Persist calibrated per-site activation absmaxes (one lexp/line)."""
    with open(path, "w") as f:
        for tag in sorted(tunes):
            f.write(f"(tag={tag},act_scale={tunes[tag].act_scale!r})\n")


def load_act_scales(path, site_tunes: dict[str, OpTune]) -> dict[str, OpTune]:
    """Apply persisted act scales onto a site-tune map. Reports the
    applied/unmatched counts — a mismatched artifact (wrong model/site
    set) silently running dynamic would masquerade as a static-int8
    measurement."""
    import copy

    from ..core.lexp import parse_lexp
    scales = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            l = parse_lexp(line)
            l.deep_inc_use_cnt()
            scales[l.get_kid("tag").leaf_val] = \
                float(l.get_kid("act_scale").leaf_val)
    out = {}
    applied = 0
    for tag, tune in site_tunes.items():
        t2 = copy.copy(tune)
        if tag in scales:
            t2.act_scale = scales[tag]
            applied += 1
        out[tag] = t2
    unmatched_sites = len(site_tunes) - applied
    unmatched_artifact = len(scales) - applied
    import sys
    # stderr: bench.py's stdout contract is exactly one JSON line
    print(f"act_scales: applied {applied}/{len(site_tunes)} site(s) from "
          f"{path}" + (f" ({unmatched_sites} site(s) stay dynamic, "
                       f"{unmatched_artifact} artifact entr(ies) unused)"
                       if unmatched_sites or unmatched_artifact else ""),
          file=sys.stderr, flush=True)
    return out
