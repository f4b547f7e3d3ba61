"""moe_rows_used.hybrid (%, program counter; layer: MoE; moves
decode_tokens_per_s): the routed (token, expert) pairs over the rows the
expert products computed, padding included (the program's counters
``moe.routed_pairs`` and ``moe.expert_rows`` over the traced window): 100 %
on a grouped path with no padding, k / n_experts on the dropless capacity
route."""


def read(data):
    counters = data.get("program_counters", {})
    pairs = counters.get("moe.routed_pairs", 0)
    rows = counters.get("moe.expert_rows", 0)
    if not pairs or not rows:
        return None
    return 100.0 * pairs / rows
