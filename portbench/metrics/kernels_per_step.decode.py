"""kernels_per_step.decode (kernels/step, device trace; layer: model step;
moves decode_tokens_per_s): the kernels the profiler saw on the card in
the traced window (copies and sets left out) over the model steps taken
there."""


def read(data):
    steps = data.get("steps")
    if not steps:
        return None
    n = sum(1 for name, _ in data.get("kernels", ())
            if not name.startswith(("Memcpy", "Memset")))
    return n / len(steps) if n else None
