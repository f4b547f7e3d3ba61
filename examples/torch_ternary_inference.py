"""Paper-technique serving path on the PyTorch port: balanced-ternary weight
quantization.

Quantizes a small dense LM's projection weights to packed 2-bit ternary
(16 weights per int32 — the MvAP trit representation applied to LM serving),
reports weight-memory savings and logits fidelity, holds the packed-matmul
kernel against the plain version, runs the same projection on the AP (one
MAC program, a bank of bounded arrays, the graph runtime) and serves a tiny
model with every MLP projection on the AP.  The steps and sizes of
``examples/ternary_inference.py``; the weights and random activations are
the port's own draws from the same seeds (``torch.Generator`` on the CPU,
then moved to the device, so the card and the CPU start from the same
numbers; not ``jax.random``), so those numbers are its own, while every
bit-exactness check must hold.

Run:  PYTHONPATH=src python examples/torch_ternary_inference.py
[--device cpu] (default ``cuda:0``: the packed matmul on the CUDA-core
kernel, every AP program on the program kernel).
"""
import argparse

import numpy as np
import torch

from repro_torch import apc
from repro_torch.configs import get_smoke_config
from repro_torch.core.ap import APStats
from repro_torch.core.energy import energy_from_stats
from repro_torch.device import resolve_device
from repro_torch.kernels.ternary_matmul.ap import ap_matmul_cycle_counts
from repro_torch.kernels.ternary_matmul.ops import (quantize_and_pack,
                                                    ternary_matmul,
                                                    ternary_matmul_op)
from repro_torch.kernels.ternary_matmul.ref import (ternary_matmul_ref,
                                                    unpack_ternary)
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import model as M
from repro_torch.models.quant import quantize_model_params
from repro_torch.serve.engine import Engine, ServeCfg


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"check failed: {what}")


def exact(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.cpu(), b.cpu()))


def seeded_params(cfg, dev) -> dict:
    """``init_params(cfg, seed=0)`` drawn on the CPU, then on ``dev``."""
    def move(node):
        return ({k: move(v) for k, v in node.items()}
                if isinstance(node, dict) else node.to(dev))
    return move(M.init_params(cfg, seed=0, device="cpu"))


def n_projection_weights(tree, path="") -> int:
    if isinstance(tree, dict):
        return sum(n_projection_weights(v, f"{path}/{k}")
                   for k, v in tree.items())
    return tree.numel() if ("mlp" in path or "attn" in path) else 0


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0)")
    dev = resolve_device(parser.parse_args(argv).device)

    cfg = get_smoke_config("qwen3-0.6b").with_(n_layers=2)
    mesh = make_smoke_mesh(dev)
    params = seeded_params(cfg, dev)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)),
        dtype=torch.int32, device=dev)}

    with torch.inference_mode():
        logits_fp = M.forward(cfg, M.cast_params(cfg, params), batch,
                              mesh=mesh).float()
        cfg_t = cfg.with_(ternary=cfg.ternary.__class__(enabled=True))
        logits_t = M.forward(cfg_t, M.cast_params(cfg_t, params), batch,
                             mesh=mesh).float()
    rel = float(torch.linalg.norm(logits_fp - logits_t)
                / torch.linalg.norm(logits_fp))
    print(f"fake-quant ternary model: relative logits delta {rel:.3f} "
          f"(untrained weights; QAT flag `ternary.qat` trains through STE)")

    # packed-kernel path against the plain version on one projection
    w = params["stack"]["pos_0"]["mlp"]["w1"][0]
    packed, scale = quantize_and_pack(w)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((8, w.shape[0]), generator=gen).to(dev)
    y_ref = ternary_matmul_ref(x, packed, scale)
    y_kern = ternary_matmul_op(x, packed, scale)
    err = float((y_kern - y_ref).abs().max())
    require(err <= 1e-4 * max(1.0, float(y_ref.abs().max())),
            "packed kernel within 1e-4 of the plain version")
    print(f"packed kernel max err vs ref: {err:.2e}")

    # AP backend: the same projection served by the associative processor.
    # Activations quantize to integers (here: round to a 3-bit grid) and
    # the dot products run as one fused MAC program — multiplier-free
    # compare/write cycles with the paper's Table XI cost model attached.
    k_ap = 64                                 # AP array column budget
    packed_ap, scale_ap = quantize_and_pack(w[:k_ap])
    x_int = torch.as_tensor(np.random.default_rng(2).integers(
        -4, 5, (4, k_ap)), dtype=torch.float32, device=dev)
    ap_stats = APStats(radix=3)
    y_ap = ternary_matmul(x_int, packed_ap, scale_ap, impl="ap",
                          stats=ap_stats)
    y_ap_ref = ternary_matmul(x_int, packed_ap, scale_ap, impl="ref")
    wd = apc.mac_acc_width(3, k_ap, 4)
    cyc = ap_matmul_cycle_counts(3, k_ap, wd)
    rep = energy_from_stats(ap_stats, n_masked=4)
    require(exact(y_ap, y_ap_ref), "impl='ap' bit-exact vs ref")
    print(f"AP backend (impl='ap'): bit-exact vs ref = "
          f"{exact(y_ap, y_ap_ref)}; K={k_ap} dot products for all outputs "
          f"in {cyc['write_cycles']} write + {cyc['compare_cycles']} compare "
          f"cycles (row-parallel over all {y_ap.numel()} cells), "
          f"{rep.total_j*1e9:.1f} nJ by the Table XI model")

    # The same matmul on a *bank* of bounded arrays: a column budget that
    # holds only 16-term MAC rows forces K-tiling (4 partial-sum programs +
    # a ripple-add reduction), row blocks stream over 2 arrays — still
    # bit-exact, with the pipelined wall-cycle model alongside.
    cols16 = apc.mac_layout(16, wd)["n_cols"]
    pool = apc.ArrayPool(n_arrays=2, rows=8, cols=cols16, device=dev)
    pool_stats = APStats(radix=3)
    y_pool = ternary_matmul(x_int, packed_ap, scale_ap, impl="ap", pool=pool,
                            stats=pool_stats)
    wall = pool.wall_cycles(y_pool.numel(), pool_stats.n_compare_cycles,
                            pool_stats.n_write_cycles)
    require(exact(y_pool, y_ap_ref), "pool route bit-exact vs ref")
    print(f"AP pool route ({pool!r}, K tiled 4x16): bit-exact vs ref = "
          f"{exact(y_pool, y_ap_ref)}; {pool_stats.n_write_cycles} write "
          f"cycles charged, {wall['write_cycles']} on the pipelined wall "
          f"clock ({wall['waves']} waves)")

    n_proj = n_projection_weights(params)
    print(f"projection weights: {n_proj/1e6:.2f}M params -> "
          f"bf16 {n_proj*2/1e6:.2f} MB vs packed ternary "
          f"{n_proj*0.25/1e6:.2f} MB (8x smaller; decode is weight-bound, "
          f"so the memory-roofline term drops ~8x on projections)")

    # --- The AP runtime: independent matmuls as ONE program graph ---------
    rt = apc.Runtime(apc.ArrayPool(n_arrays=2, rows=8, cols=cols16,
                                   device=dev))
    rt_stats = APStats(radix=3)
    y_rt = ternary_matmul(x_int, packed_ap, scale_ap, impl="ap", runtime=rt,
                          stats=rt_stats)
    require(exact(y_rt, y_ap_ref), "runtime route bit-exact vs ref")
    print(f"AP runtime route (one matmul): bit-exact vs ref = "
          f"{exact(y_rt, y_ap_ref)}; makespan "
          f"{rt.last_report['makespan_cycles']} == sequential "
          f"{rt.last_report['sequential_cycles']} cycles (bank saturated)")

    w_ter_ap = unpack_ternary(packed_ap, dtype=torch.int8)        # [K, N]
    x2_int = torch.as_tensor(np.random.default_rng(3).integers(
        -4, 5, (4, k_ap)), dtype=torch.float32, device=dev)
    tiled_ap = apc.compile_mac_tiled(3, k_ap, wd, 16, max_cols=cols16)
    macs = [apc.matmul_mac_rows(xm.to(torch.int32), w_ter_ap) + (tiled_ap,)
            for xm in (x_int, x2_int)]
    # taller arrays (4 x 256 rows: each 512-row launch is 2 blocks, leaving
    # half the bank idle), so the second matmul's tiles slot into the gap
    rt = apc.Runtime(apc.ArrayPool(n_arrays=4, rows=256, cols=cols16,
                                   device=dev))
    d1, d2 = rt.run_mac_graph(macs)
    y_two = [apc.decode_signed_digits_jnp(d, 3).reshape(4, -1)
             .to(torch.float32) * scale_ap[None, :] for d in (d1, d2)]
    ok = exact(y_two[0], y_ap_ref) and exact(
        y_two[1], ternary_matmul(x2_int, packed_ap, scale_ap, impl="ref"))
    require(ok, "two matmuls in one graph bit-exact vs ref")
    rep = rt.last_report
    print(f"AP runtime, TWO independent matmuls in one graph: bit-exact = "
          f"{ok}; makespan {rep['makespan_cycles']} vs sequential "
          f"{rep['sequential_cycles']} cycles on {rep['n_arrays_total']} "
          f"arrays ({rep['sequential_cycles'] / rep['makespan_cycles']:.2f}x "
          f"pipelined)")

    # --- AP-backed model serving ------------------------------------------
    # A whole (tiny) model with every packed MLP projection served by the
    # AP runtime: the engine wraps its steps in ap_serving, gate/up
    # projections of each MLP run as independent subgraphs, and the request
    # returns with aggregated counters + Table XI energy.
    cfg_ap = cfg.with_(n_layers=1, d_model=32, d_ff=48, n_heads=2,
                       n_kv_heads=2, head_dim=16, vocab=64)
    params_ap = M.cast_params(cfg_ap, quantize_model_params(
        seeded_params(cfg_ap, dev)))
    ctx = apc.APServeContext(apc.Runtime(apc.ArrayPool(
        n_arrays=4, rows=64, cols=96, device=dev)), x_levels=7)
    eng = Engine(cfg_ap, params_ap, ServeCfg(max_len=8), ap_ctx=ctx,
                 mesh=mesh)
    toks = eng.generate(np.array([[3, 5]], dtype=np.int32), 1)
    r = eng.ap_report()
    require(r["n_graphs"] > 0 and r["n_programs"] > 0,
            "the request ran its projections on the AP")
    print(f"AP-backed serve request (1 layer, d={cfg_ap.d_model}): "
          f"generated {toks.tolist()}; {r['n_programs']} AP programs in "
          f"{r['n_graphs']} graphs, {r['write_cycles']} write + "
          f"{r['compare_cycles']} compare cycles, "
          f"{r['energy_total_j']*1e9:.1f} nJ (Table XI); pipelined "
          f"makespan {r['makespan_cycles']} vs {r['sequential_cycles']} "
          f"sequential cycles on {r['n_arrays_total']} arrays")


if __name__ == "__main__":
    main()
