"""program_launches_per_step.ap (launches/step, program counter; layer: AP
runtime; moves ap_tokens_per_s): program-kernel launches
(``launch_counts["tap_run_program"]``) in the traced window over the
server's waves, each a step of every request in flight."""


def read(data):
    waves = data.get("waves")
    n = data.get("launches", {}).get("tap_run_program", 0)
    if not waves or not n:
        return None
    return n / waves
