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
``pool.ArrayPool``           A bank of bounded MvCAM arrays: row blocks
                             dealt over arrays, pipelined wall cycles,
                             resident weight planes, the fault model.
``pool.run_mac_tiled``       The K-tiled MAC on the executor or a pool, tile
                             by tile, folded by ``graph.mac_fold_plan``.
``faults.FaultModel``        Seeded stuck cells, write flips, wear and dead
                             arrays; checksum detection, retry, retirement.
``graph.ProgramGraph``       A DAG of program launches; ``graph_makespan``
                             is its occupancy model, ``coalesce_graphs``
                             row-concatenates like nodes of many graphs.
``runtime.DevicePool``       The bank spread over a list of devices, counters
                             summed across shards.
``runtime.Runtime``          Topological-wavefront executor + occupancy
                             model over a pool.
``power.PowerTimeline``      Per-array power from the schedule and the exact
                             per-block counters (Table XI).
``layers.APLinear``          A model projection as a cached K-tiled MAC;
                             ``APServeContext`` aggregates per-request
                             APStats / Table XI energy across every AP-
                             served projection of a forward pass.
==========================  =================================================

Typical use::

    from repro_torch import apc
    compiled = apc.compile_named("add", radix=3, width=20)
    out, traced = apc.execute(arr, compiled, collect_stats=True)
    stats = apc.to_ap_stats(traced, compiled, arr.shape[0], radix=3)

or via the drivers: ``repro_torch.core.ap.ripple_add(..., engine="apc")``.
"""
from . import exec as exec  # noqa: PLC0414 — re-export the module
from . import (caches as caches_mod, faults as faults_mod,
               graph as graph_mod, ir, layers as layers_mod, lower, mac,
               metrics as metrics_mod, pool as pool_mod, power as power_mod,
               runtime as runtime_mod, stats, trace as trace_mod)
from .caches import (ResidentError, ResidentEvicted, ResidentHandle,
                     ResidentStale, ResidentStore, cache_stats,
                     clear_compile_caches)
from .exec import execute, execute_sharded, run
from .faults import (FaultConfig, FaultDetected, FaultModel,
                     fault_config_from_env, faults_enabled)
from .graph import (CARRIED, FoldStage, GraphNode, MergedGraphView,
                    MergedSlice, ProgramGraph, coalesce_graphs,
                    fold_stage_input, graph_makespan, mac_fold_plan)
from .layers import (N_MASKED_MAC, APCall, APLinear, APServeContext, APSink,
                     ap_moe_dispatch, ap_request_scope, ap_serving,
                     current_ap_context, plain_ap_projections)
from .runtime import DevicePool, GraphResult, Runtime
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
from .pool import (ArrayPool, drain_fault_charges, resident_enabled,
                   run_mac_tiled, run_pooled)
from .power import (Counters, PowerAccum, PowerInterval, PowerTimeline,
                    emit_counter_tracks, graph_power, partition_blocks,
                    pool_power)
from .stats import TracedStats, accumulate, mac_sparsity, to_ap_stats
from .trace import Tracer, current_tracer, tracing, validate_chrome_trace

__all__ = [
    "caches_mod", "exec", "faults_mod", "graph_mod", "ir", "layers_mod",
    "lower", "mac", "metrics_mod", "pool_mod", "power_mod", "runtime_mod",
    "stats", "trace_mod",
    "MetricsRegistry", "get_registry",
    "Tracer", "current_tracer", "tracing", "validate_chrome_trace",
    "cache_stats", "clear_compile_caches",
    "ResidentError", "ResidentEvicted", "ResidentHandle", "ResidentStale",
    "ResidentStore",
    "execute", "execute_sharded", "run",
    "FaultConfig", "FaultDetected", "FaultModel", "fault_config_from_env",
    "faults_enabled", "drain_fault_charges",
    "CARRIED", "FoldStage", "GraphNode", "MergedGraphView", "MergedSlice",
    "ProgramGraph", "coalesce_graphs", "fold_stage_input",
    "graph_makespan", "mac_fold_plan",
    "N_MASKED_MAC", "APCall", "APLinear", "APServeContext", "APSink",
    "ap_moe_dispatch", "ap_request_scope", "ap_serving",
    "current_ap_context", "plain_ap_projections",
    "DevicePool", "GraphResult", "Runtime",
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
    "ArrayPool", "resident_enabled", "run_mac_tiled", "run_pooled",
    "Counters", "PowerAccum", "PowerInterval", "PowerTimeline",
    "emit_counter_tracks", "graph_power", "partition_blocks", "pool_power",
    "TracedStats", "accumulate", "mac_sparsity", "to_ap_stats",
]
