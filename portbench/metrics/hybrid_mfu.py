"""hybrid_mfu (%, program counter; layer: model step; moves
decode_tokens_per_s): the hybrid model's FLOPs for the tokens each step
fed (``portbench.work_hybrid.steps_flops``: the Mamba-2 projections, state
update and read-out, attention over the written positions, the router,
the routed and shared experts, the head), over the traced window at the
card's 989 TFLOP/s."""
from portbench.work import BF16_FLOPS
from portbench.work_hybrid import steps_flops


def read(data):
    steps = data.get("steps")
    if not steps:
        return None
    return 100.0 * steps_flops(data["model"], steps) / (
        data["window_s"] * BF16_FLOPS)
