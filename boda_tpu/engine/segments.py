"""Plan segmentation: partition a lowered Plan into sequential stage
segments, each a jittable fn over the fused program's INTERIOR storage
form (same NHWC/bf16 edges as the shipped whole-net program).

Extracted from the cnet_stage_probe mode so pipeline parallelism can ride
the same grouping (VERDICT r3 #6: GPipe over the *imported* pipe, not toy
stages). Reference context: the reference's conv_pipe had no stage
notion — its per-op granularity is covered by ops_prof; stage grouping is
the unit this build uses for ceiling proofs and pp sharding.
"""

from __future__ import annotations

from ..core.error import RtErr


class PlanSegment:
    """One stage: `fn(x, *ws) -> y` where x is the in_node's value in
    storage form, ws are the `weight_names` values (resolve_plan_weights
    order), and y is the out_node's storage-form value."""

    __slots__ = ("name", "steps", "fn", "weight_names", "in_node",
                 "out_node", "flops", "zero_init")

    def __init__(self, name, steps, fn, weight_names, in_node, out_node,
                 flops, zero_init):
        self.name = name
        self.steps = steps
        self.fn = fn
        self.weight_names = weight_names
        self.in_node = in_node
        self.out_node = out_node
        self.flops = flops
        self.zero_init = zero_init


def parse_stages_spec(spec: str) -> list[tuple[str, tuple[str, ...]]]:
    """'name:prefix[+prefix...]|...' → [(name, prefixes), ...]."""
    groups = []
    for part in spec.split("|"):
        name, _, prefs = part.partition(":")
        groups.append((name, tuple(p for p in prefs.split("+") if p)))
    return groups


def build_plan_segments(plan, weights: dict, stages_spec: str,
                        what: str = "plan segmentation"):
    """Partition plan.steps into stage segments by call-tag prefix.

    Each segment must consume exactly ONE external activation node (its
    input); shortcut edges must stay in-segment — the same constraint the
    stage probe enforces. Empty groups are dropped. Returns
    [PlanSegment, ...] in spec order."""
    from ..ops.registry import get_template

    groups = parse_stages_spec(stages_spec)

    def group_of(tag):
        for name, prefs in groups:
            if any(tag.startswith(p) for p in prefs):
                return name
        return None

    segs: dict[str, list] = {name: [] for name, _ in groups}
    for s in plan.steps:
        g = group_of(s.call_tag)
        if g is not None:
            segs[g].append(s)

    out = []
    for name, _prefs in groups:
        seg = segs[name]
        if not seg:
            continue
        built = []
        seg_weights: list[str] = []
        produced: set[str] = set()
        consumed: list[str] = []
        zero_init: list[str] = []
        for s in seg:
            tmpl = get_template(s.sig.func_name)
            rfs = tmpl.check_args(s.sig)
            built.append((tmpl.build(rfs), tmpl, s))
            io_args = set(tmpl.io_args())
            for an in tmpl.in_args() + tmpl.io_args():
                n = s.arg_nodes.get(an)
                if n is None or n in produced:
                    continue
                if n in weights:
                    if n not in seg_weights:
                        seg_weights.append(n)
                elif an in io_args and s.sig.func_name == "copy":
                    # first touch is the Concat write-slice target (copy
                    # ignores prior content at its chan range): zero-init
                    # in-seg, exactly as build_fused_forward does on first
                    # touch. Other io first-touchers (in-place
                    # relu/dropout) READ content — those stay external
                    zero_init.append(n)
                    produced.add(n)
                else:
                    if n not in consumed:
                        consumed.append(n)
            for an in tmpl.out_args() + tmpl.io_args():
                if an in s.arg_nodes:
                    produced.add(s.arg_nodes[an])
        if len(consumed) != 1:
            raise RtErr(f"{what}: stage '{name}' must consume exactly one "
                        f"external activation node, got "
                        f"{consumed or '[none]'} — adjust the stages= "
                        f"grouping so shortcut edges stay in-stage")
        in_node = consumed[0]
        out_node = [s.arg_nodes[an] for fn, tmpl, s in built[::-1]
                    for an in tmpl.out_args() + tmpl.io_args()
                    if an in s.arg_nodes][0]
        flops = sum(get_template(s.sig.func_name).flops(
            get_template(s.sig.func_name).check_args(s.sig)) for s in seg)

        from .rtc_fwd import _storage_zeros

        def seg_fn(x, *ws, _built=tuple(built), _wn=tuple(seg_weights),
                   _in=in_node, _zi=tuple(zero_init), _out=out_node):
            vals = dict(zip(_wn, ws))
            vals[_in] = x
            for n in _zi:  # INOUT targets (concat out buffers)
                vals[n] = _storage_zeros(plan.node_dims[n], plan)
            for fn, tmpl, s in _built:
                ins = [vals[s.arg_nodes[an]]
                       for an in tmpl.in_args() + tmpl.io_args()
                       if an in s.arg_nodes]
                outs = fn(*ins)
                if not isinstance(outs, (tuple, list)):
                    outs = (outs,)
                for an, ov in zip(tmpl.out_args() + tmpl.io_args(), outs):
                    if an in s.arg_nodes:
                        vals[s.arg_nodes[an]] = ov
            return vals[_out]

        out.append(PlanSegment(name, seg, seg_fn, tuple(seg_weights),
                               in_node, out_node, flops, tuple(zero_init)))
    return out


def build_remat_forward(plan, weights: dict, stages_spec: str):
    """Gradient-checkpointed forward: the plan's stages chained with
    `jax.checkpoint` around each segment, so a backward pass stores only
    the stage-BOUNDARY activations and recomputes each stage's interior
    during its grad — the recompute-vs-store lever for training (HBM
    traffic/capacity for ~1 extra fwd of FLOPs; VERDICT r3 #2).

    Same calling contract as build_fused_forward — fwd(inputs, weights)
    -> {out_node: logical NCHW value} — but returns ONLY the final
    segment's out node; trailing plan steps not covered by any stage
    group (e.g. a softmax when training from logits) are dropped.
    Non-trailing coverage gaps are an error. Reference context: the
    reference stored every bck-op input (conv_util.cc:732-800
    add_bck_ops materializes all forward nodes); checkpointing is the
    alternative XLA can't derive on its own."""
    import jax

    from .rtc_fwd import _storage_in, _storage_out

    segments = build_plan_segments(plan, weights, stages_spec,
                                   what="build_remat_forward")
    if not segments:
        raise RtErr("build_remat_forward: stage spec matched no steps")
    covered = {id(s) for ps in segments for s in ps.steps}
    uncov = [s for s in plan.steps if id(s) not in covered]
    # only a contiguous TAIL may be uncovered (dropped post-logits ops)
    last_ix = max(i for i, s in enumerate(plan.steps) if id(s) in covered)
    bad = [s.call_tag for s in plan.steps[:last_ix] if id(s) not in covered]
    if bad:
        raise RtErr(f"build_remat_forward: steps not covered by any stage "
                    f"group (and not trailing): {bad}")
    for prev, nxt in zip(segments, segments[1:]):
        if nxt.in_node != prev.out_node:
            raise RtErr(f"build_remat_forward: stage '{nxt.name}' input "
                        f"'{nxt.in_node}' != previous stage "
                        f"'{prev.name}' output '{prev.out_node}' — "
                        f"stages must chain")
    dropped = [s.call_tag for s in uncov]
    ckpt_fns = [jax.checkpoint(ps.fn) for ps in segments]

    def fwd(inputs: dict, weights: dict):
        if segments[0].in_node not in inputs:
            raise RtErr(f"build_remat_forward: missing input "
                        f"'{segments[0].in_node}'")
        x = _storage_in(inputs[segments[0].in_node], plan)
        for ps, cfn in zip(segments, ckpt_fns):
            try:
                ws = [weights[n] for n in ps.weight_names]
            except KeyError as e:
                raise RtErr(f"build_remat_forward: weight node {e} missing "
                            f"from the weights dict (resolve_plan_weights "
                            f"on THIS plan)")
            x = cfn(x, *ws)
        out = segments[-1].out_node
        return {out: _storage_out(x, plan.node_dims[out], plan)}

    fwd.out_node = segments[-1].out_node
    fwd.dropped_tail = tuple(dropped)
    return fwd
