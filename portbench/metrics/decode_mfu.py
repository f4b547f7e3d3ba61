"""decode_mfu (%, program counter; layer: model step; moves
decode_tokens_per_s): the served model's FLOPs, each step counted dense
from the configuration's shapes (``portbench.work.steps_flops``: attention
over the positions written) for the tokens it stepped, over the traced
window at the card's 989 TFLOP/s."""
from portbench.work import BF16_FLOPS, steps_flops


def read(data):
    steps = data.get("steps")
    if not steps:
        return None
    return 100.0 * steps_flops(data["model"], steps) / (
        data["window_s"] * BF16_FLOPS)
