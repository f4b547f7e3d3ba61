"""device_idle.ap (%, device trace; layer: device; moves
ap_tokens_per_s): the share of the traced window in which no kernel, copy
or set ran on the card."""


def read(data):
    if data.get("busy_s") is None or data["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - data["busy_s"] / data["window_s"])
