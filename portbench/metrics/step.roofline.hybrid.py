"""step.roofline.hybrid (%, device trace; layer: device; moves
decode_tokens_per_s): the least time of the traced window's model steps
(``portbench.work_hybrid.step_seconds``: each step's compulsory bytes at
3.35 TB/s, or its FLOPs at 989 TFLOP/s where longer) over the card's busy
time there.  The whole step's roofline share; at most 100 % by
construction."""
from portbench.work_hybrid import step_seconds


def read(data):
    steps = data.get("steps")
    if not steps or not data.get("busy_s"):
        return None
    least = sum(step_seconds(data["model"], pos, b) for pos, b in steps)
    return 100.0 * least / data["busy_s"]
