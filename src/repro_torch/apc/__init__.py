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
==========================  =================================================

Typical use::

    from repro_torch import apc
    compiled = apc.compile_named("add", radix=3, width=20)
    out, traced = apc.execute(arr, compiled, collect_stats=True)
    stats = apc.to_ap_stats(traced, compiled, arr.shape[0], radix=3)

or via the drivers: ``repro_torch.core.ap.ripple_add(..., engine="apc")``.
"""
from . import exec as exec  # noqa: PLC0414 — re-export the module
from . import ir, lower, metrics as metrics_mod, stats, trace as trace_mod
from .exec import execute, run
from .ir import (AffineCol, ApplyLUT, CompareWrite, ForDigit, Program,
                 RelCol, SetCol, ZeroCol, digit)
from .lower import (KERNEL_VARIANTS, CompiledProgram, PackedProgram, Step,
                    compile_named, compile_program, default_kernel_variant,
                    elementwise_program, lower as lower_program,
                    multiply_program, negate_program, pack_steps,
                    resolve_schedule, ripple_add_program,
                    ripple_sub_program)
from .metrics import MetricsRegistry, get_registry
from .stats import TracedStats, accumulate, to_ap_stats
from .trace import (Tracer, current_tracer, global_tracer,
                    reset_global_tracer, tracing, validate_chrome_trace)

__all__ = [
    "exec", "ir", "lower", "metrics_mod", "stats", "trace_mod",
    "MetricsRegistry", "get_registry",
    "Tracer", "current_tracer", "global_tracer", "reset_global_tracer",
    "tracing", "validate_chrome_trace",
    "execute", "run",
    "AffineCol", "ApplyLUT", "CompareWrite", "ForDigit", "Program", "RelCol",
    "SetCol", "ZeroCol", "digit",
    "KERNEL_VARIANTS", "CompiledProgram", "PackedProgram", "Step",
    "compile_named", "compile_program", "default_kernel_variant",
    "elementwise_program", "lower_program", "multiply_program",
    "negate_program", "pack_steps", "resolve_schedule",
    "ripple_add_program", "ripple_sub_program",
    "TracedStats", "accumulate", "to_ap_stats",
]
