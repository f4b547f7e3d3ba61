"""tap_program.roofline.ap (%, device trace; layer: kernels; moves
ap_tokens_per_s): the least time of the program launches' work over the
profiler's device time of the program kernel (``tap_program_kernel``).
Each launch's work comes from its compiled schedule and row count
(``portbench.work.program_launch_seconds``): each row's one-byte digits
read and written once at 3.35 TB/s, or its compare and write cell
operations at the INT32 rate with four byte cells an operation.  No
latency term."""
from portbench.work import program_launch_seconds


def read(data):
    dev = sum(d for name, d in data.get("kernels", ())
              if "tap_program_kernel" in name)
    launches = data.get("tap_launches")
    if dev <= 0 or not launches:
        return None
    least = sum(program_launch_seconds(r, c, cells)
                for r, c, cells in launches)
    return 100.0 * least / dev
