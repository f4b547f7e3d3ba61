"""moe_ms_per_step.hybrid (ms/step, program spans; layer: model step;
moves decode_tokens_per_s): host time inside the program's ``model.moe``
spans (each MoE FFN call, routed and shared experts) over the model steps
of the traced window."""


def read(data):
    spans = [s for s in data.get("program_spans", ())
             if s["name"] == "model.moe"]
    steps = data.get("steps")
    if not spans or not steps:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in spans) / len(steps)
