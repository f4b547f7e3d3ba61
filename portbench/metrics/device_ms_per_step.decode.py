"""device_ms_per_step.decode (ms/step, device trace; layer: device; moves
decode_tokens_per_s): the card's busy time in the traced window (kernels,
copies and sets, overlaps counted once) over the model steps taken there.
The host-paced step's rate spreads with the host's CPU; this is the
device's own work a step, which the kernels move and the host does not."""


def read(data):
    steps = data.get("steps")
    if not steps or not data.get("busy_s"):
        return None
    return 1e3 * data["busy_s"] / len(steps)
