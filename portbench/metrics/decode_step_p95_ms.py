"""decode_step_p95_ms (ms, host clock): the 95th percentile, over every
decode step of every request in the window, of the time from one sampled
token reaching the host to the next (the gap between output tokens that a
user sees)."""
import numpy as np


def read(data):
    gaps = [b - a for t in data["token_times"] for a, b in zip(t, t[1:])]
    if not gaps:
        return None
    return 1e3 * float(np.percentile(np.asarray(gaps, np.float64), 95))
