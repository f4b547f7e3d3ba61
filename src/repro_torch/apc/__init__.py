"""AP program compiler: microcode IR + fused executor, in PyTorch.

The layers mirror :mod:`repro.apc` of the JAX package, module for module:

==========================  =================================================
IR / compiler concept        Paper concept
==========================  =================================================
``ir.ApplyLUT``              One LUT-schedule application (§IV.A Table VII /
                             §V Table IX) at one digit position.
``ir.ApplyLUT.extra_key``    Predicated execution: every compare key is
                             extended with exact matches (the shift-and-add
                             multiplier's "only rows with B_j == t" gate).
``ir.SetCol / ZeroCol``      The unconditional carry-clear write that opens
                             every multi-digit operation (§IV.C: C <- 0).
``ir.CompareWrite``          A single masked compare + write cycle (§III
                             Table III semantics) outside any LUT.
``ir.ForDigit``              Digit-serial ripple over the p positions of a
                             multi-digit word.
``lower.Step``               One compare-block + write cycle.
``lower.CompiledProgram``    The whole program flattened to a static
                             schedule + packed to dense tensors.
``exec.execute``             Row-parallel replay in one CUDA kernel launch:
                             every row takes every compare, the array read
                             and written once.
``stats.TracedStats``        The functional co-simulator counters (§VI:
                             Table V set/reset rules, mismatch histogram for
                             the matchline energy model) from the kernel.
``mac.compile_mac``          The ternary dot product as one program: K
                             predicated add/sub sweeps on an accumulator
                             (``compile_mac_tiled`` splits K into tiles
                             folded by ripple-add reductions).
``pool.run_mac_tiled``       The K-tiled MAC on the executor, tile by tile,
                             folded by ``graph.mac_fold_plan``.
==========================  =================================================

Typical use::

    from repro_torch import apc
    compiled = apc.compile_named("add", radix=3, width=20)
    out, traced = apc.execute(arr, compiled, collect_stats=True)
    stats = apc.to_ap_stats(traced, compiled, arr.shape[0], radix=3)

or via the drivers: ``repro_torch.core.ap.ripple_add(..., engine="apc")``.
"""
from . import exec as exec  # noqa: PLC0414 — re-export the module
from . import (caches as caches_mod, graph as graph_mod, ir, lower, mac,
               metrics as metrics_mod, pool as pool_mod, stats,
               trace as trace_mod)
from .caches import (ResidentError, ResidentEvicted, ResidentHandle,
                     ResidentStale, ResidentStore, cache_stats,
                     clear_compile_caches)
from .exec import execute, run
from .graph import CARRIED, FoldStage, fold_stage_input, mac_fold_plan
from .ir import (AffineCol, ApplyLUT, CompareWrite, ForDigit, Program,
                 RelCol, SetCol, ZeroCol, digit)
from .lower import (KERNEL_VARIANTS, CompiledProgram, PackedProgram, Step,
                    compile_named, compile_program, default_kernel_variant,
                    elementwise_program, lower as lower_program,
                    multiply_program, negate_program, pack_steps,
                    resolve_schedule, ripple_add_program,
                    ripple_sub_program)
from .mac import (SUPPORT_DENSE, TiledMac, assemble_mac_rows_jnp,
                  compile_mac, compile_mac_reduce, compile_mac_tiled,
                  decode_mac_acc, decode_mac_acc_jnp,
                  decode_signed_digits_jnp, encode_mac_rows,
                  encode_mac_rows_jnp, encode_mac_x_rows_jnp,
                  encode_weight_digits_jnp, mac_acc_width, mac_layout,
                  mac_program, mac_reduce_program, mac_weight_support,
                  matmul_mac_rows, weight_digest)
from .metrics import MetricsRegistry, get_registry
from .pool import run_mac_tiled
from .stats import TracedStats, accumulate, mac_sparsity, to_ap_stats
from .trace import (Tracer, current_tracer, global_tracer,
                    reset_global_tracer, tracing, validate_chrome_trace)

__all__ = [
    "caches_mod", "exec", "graph_mod", "ir", "lower", "mac", "metrics_mod",
    "pool_mod", "stats", "trace_mod",
    "MetricsRegistry", "get_registry",
    "Tracer", "current_tracer", "global_tracer", "reset_global_tracer",
    "tracing", "validate_chrome_trace",
    "cache_stats", "clear_compile_caches",
    "ResidentError", "ResidentEvicted", "ResidentHandle", "ResidentStale",
    "ResidentStore",
    "execute", "run",
    "CARRIED", "FoldStage", "fold_stage_input", "mac_fold_plan",
    "AffineCol", "ApplyLUT", "CompareWrite", "ForDigit", "Program", "RelCol",
    "SetCol", "ZeroCol", "digit",
    "KERNEL_VARIANTS", "CompiledProgram", "PackedProgram", "Step",
    "compile_named", "compile_program", "default_kernel_variant",
    "elementwise_program", "lower_program", "multiply_program",
    "negate_program", "pack_steps", "resolve_schedule",
    "ripple_add_program", "ripple_sub_program",
    "SUPPORT_DENSE", "TiledMac", "assemble_mac_rows_jnp", "compile_mac",
    "compile_mac_reduce", "compile_mac_tiled",
    "decode_mac_acc", "decode_mac_acc_jnp", "decode_signed_digits_jnp",
    "encode_mac_rows", "encode_mac_rows_jnp", "encode_mac_x_rows_jnp",
    "encode_weight_digits_jnp", "mac_acc_width", "mac_layout",
    "mac_program", "mac_reduce_program", "mac_weight_support",
    "matmul_mac_rows", "weight_digest",
    "run_mac_tiled",
    "TracedStats", "accumulate", "mac_sparsity", "to_ap_stats",
]
