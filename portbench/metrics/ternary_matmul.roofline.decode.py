"""ternary_matmul.roofline.decode (%, device trace; layer: kernels; moves
decode_tokens_per_s): the least time of the packed-ternary products (the
words, x and scale read once and y written once at 3.35 TB/s, or 2·M·K·N
at 989 TFLOP/s, whichever is longer; ``portbench.work``) over the
profiler's device time of both packed-matmul kernels
(``ternary_matmul_kernel``, ``ternary_matmul_tc_kernel``)."""
from portbench.work import packed_matmul_seconds


def read(data):
    dev = sum(d for name, d in data.get("kernels", ())
              if "ternary_matmul" in name and "kernel" in name)
    launches = data.get("matmul_launches")
    if dev <= 0 or not launches:
        return None
    least = sum(packed_matmul_seconds(m, k, n, xb)
                for m, k, n, xb in launches)
    return 100.0 * least / dev
