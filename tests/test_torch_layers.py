"""The port's AP-backed layers (``repro_torch.apc.layers``) against the
reference's (``repro.apc.layers``), on the CPU.

The same numpy inputs (made from a seed) go to both; outputs must be
bit-identical (tolerance: none) and report dicts equal, key for key.  The
reference's pool runs its program kernel in interpret mode, the port's
``ArrayPool(device="cpu")`` runs the kernel's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import apc as rapc
from repro.apc.metrics import get_registry as ref_registry
from repro.kernels.ternary_matmul.ref import pack_ternary as ref_pack
from repro_torch import apc
from repro_torch.apc import layers
from repro_torch.apc.metrics import get_registry

POOL = dict(n_arrays=4, rows=16, cols=96)
D_IN, D_OUT, T = 20, 6, 3


def _ctxs(x_levels=7, **pool):
    geo = dict(POOL, **pool)
    ref = rapc.APServeContext(rapc.Runtime(rapc.ArrayPool(**geo)),
                              x_levels=x_levels)
    mine = apc.APServeContext(apc.Runtime(apc.ArrayPool(**geo,
                                                        device="cpu")),
                              x_levels=x_levels)
    return ref, mine


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(mine, want):
    assert mine.dtype == torch.float32 or mine.dtype == torch.int32
    np.testing.assert_array_equal(_np(mine), _np(want))


def _report_equal(mine: dict, want: dict):
    assert set(mine) == set(want)
    for key, val in want.items():
        assert mine[key] == val, key


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["normal", "halves", "zeros", "bf16"])
def test_quantize_matches_reference(case):
    """fp32 operation order of the reference: max|x| / x_levels clamped at
    1e-8, round(x / s) half to even, clip; bit-identical."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (5, 17)).astype(np.float32)
    if case == "halves":                 # exact .5 multiples of the scale
        x = (rng.integers(-14, 15, (5, 17)) / 2).astype(np.float32)
        x[0, 0] = 7.0                    # s == 1
    elif case == "zeros":
        x = np.zeros((3, 4), np.float32)
    ref, mine = _ctxs()
    if case == "bf16":
        xr = jnp.asarray(x, jnp.bfloat16)
        xm = torch.from_numpy(x).to(torch.bfloat16)
    else:
        xr, xm = jnp.asarray(x), torch.from_numpy(x)
    want_i, want_s = ref.quantize(xr)
    got_i, got_s = mine.quantize(xm)
    assert got_i.dtype == torch.int32 and got_s.dtype == torch.float32
    _same(got_i, want_i)
    assert float(got_s) == float(want_s)


# ---------------------------------------------------------------------------
# APLinear
# ---------------------------------------------------------------------------

def _dense(seed, k=D_IN, n=D_OUT):
    return np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)


def test_aplinear_from_dense_matches_reference():
    """The absmean ternarization: the same trits; the scale, a float mean
    over K, within rtol 1e-6 (XLA and torch sum in different orders: a
    few ulp at K = 100)."""
    w = _dense(0, k=100)
    rl = rapc.APLinear.from_dense(jnp.asarray(w))
    ml = apc.APLinear.from_dense(torch.from_numpy(w))
    _same(ml.w_ter.to(torch.int32), rl.w_ter.astype(jnp.int32))
    np.testing.assert_allclose(_np(ml.w_scale), _np(rl.w_scale), rtol=1e-6,
                               atol=0)
    assert ml._support == rl._support and ml._digest == rl._digest


def _ref_ternary(w):
    """The reference's ternarization of ``w``, as numpy (both sides take
    it where the AP route itself is compared)."""
    from repro.kernels.ternary_matmul.ref import quantize_ternary
    w_ter, scale = quantize_ternary(jnp.asarray(w, jnp.float32))
    return np.array(w_ter), np.array(scale)


@pytest.mark.parametrize("sparse", [True, False])
def test_aplinear_call_matches_reference(sparse):
    w_ter, scale = _ref_ternary(_dense(0))
    x = np.random.default_rng(2).normal(size=(T, D_IN)).astype(np.float32)
    ref, mine = _ctxs()
    rl = rapc.APLinear(jnp.asarray(w_ter), jnp.asarray(scale), sparse=sparse)
    ml = apc.APLinear(torch.from_numpy(w_ter), torch.from_numpy(scale),
                      sparse=sparse)
    assert (ml.kp, ml.n) == (rl.kp, rl.n)
    assert ml._support == rl._support and ml._digest == rl._digest
    assert ml.weight_sparsity == rl.weight_sparsity
    want = rl(jnp.asarray(x), ref)
    got = ml(torch.from_numpy(x), mine)
    assert got.shape == (T, D_OUT)
    _same(got, want)
    _report_equal(mine.report(), ref.report())
    assert mine.cache_stats()["resident"] == ref.cache_stats()["resident"]


def test_aplinear_from_packed_matches_reference():
    """Packed serving weights (the reference's packer), K padded past x's
    width: the pack-time padding rows are zero weights."""
    rng = np.random.default_rng(3)
    w_ter = rng.integers(-1, 2, (32, 5)).astype(np.int8)
    scale = rng.uniform(0.5, 2, 5).astype(np.float32)
    packed = np.array(ref_pack(jnp.asarray(w_ter)))
    x = rng.normal(size=(2, 27)).astype(np.float32)     # K = 27 < 32
    ref, mine = _ctxs()
    rl = rapc.APLinear.from_packed(jnp.asarray(packed), jnp.asarray(scale),
                                   label="w")
    ml = apc.APLinear.from_packed(torch.from_numpy(packed),
                                  torch.from_numpy(scale), label="w")
    _same(ml.w_ter.to(torch.int32), w_ter.astype(np.int32))
    assert repr(ml) == repr(rl)
    _same(ml(torch.from_numpy(x), mine), rl(jnp.asarray(x), ref))
    _report_equal(mine.report(), ref.report())
    with pytest.raises(ValueError, match="K=33"):
        ml.add_call(apc.ProgramGraph(),
                    torch.zeros((1, 33), dtype=torch.int32),
                    max_cols=96, max_q=7)


def test_add_call_two_projections_one_graph():
    """Gate and up projections as independent subgraphs of one graph: the
    graph's nodes, labels and meta, and both decodes, as the reference's."""
    w1, w3 = _dense(4), _dense(5)
    x = np.random.default_rng(6).normal(size=(T, D_IN)).astype(np.float32)
    ref, mine = _ctxs()
    rstore, mstore = ref.runtime.pool.resident, mine.runtime.pool.resident
    outs = []
    for ctx, mod, store, arr in ((ref, rapc, rstore, jnp.asarray),
                                 (mine, apc, mstore, torch.from_numpy)):
        la = mod.APLinear(*map(arr, _ref_ternary(w1)), label="g",
                          store=store)
        lb = mod.APLinear(*map(arr, _ref_ternary(w3)), label="u",
                          store=store)
        g = mod.ProgramGraph()
        x_int, s = ctx.quantize(arr(x))
        ca = la.add_call(g, x_int, max_cols=ctx.max_cols, max_q=7)
        cb = lb.add_call(g, x_int, max_cols=ctx.max_cols, max_q=7)
        res = ctx.run_graph(g)
        outs.append((g, ca.decode(res, s), cb.decode(res, s)))
    (rg, ra, rb), (mg, ma, mb) = outs
    assert [n.label for n in mg.nodes] == [n.label for n in rg.nodes]
    assert [n.deps for n in mg.nodes] == [n.deps for n in rg.nodes]
    assert mg.meta == rg.meta
    _same(ma, ra)
    _same(mb, rb)
    _report_equal(mine.report(), ref.report())


def test_pinning_hits_and_encodes_match_reference():
    """Weight-stationary: a pin at construction encodes once, every later
    call hits; a second projection under the same label pins over it (the
    shared ``lin:{label}`` key), so the first one's next call re-encodes."""
    w, w2 = _dense(7), _dense(8)
    x = np.random.default_rng(9).normal(size=(T, D_IN)).astype(np.float32)
    ref, mine = _ctxs()
    got = {}
    for name, ctx, mod, arr, reg in (
            ("ref", ref, rapc, jnp.asarray, ref_registry()),
            ("mine", mine, apc, torch.from_numpy, get_registry())):
        before = reg.counter("mac.weight_encodes").value
        lin = mod.APLinear(*map(arr, _ref_ternary(w)), label="mlp.w1",
                           store=ctx.runtime.pool.resident)
        other = mod.APLinear(*map(arr, _ref_ternary(w2)), label="mlp.w1")
        outs = [lin(arr(x), ctx), lin(arr(x), ctx), other(arr(x), ctx),
                lin(arr(x), ctx)]
        got[name] = (outs, reg.counter("mac.weight_encodes").value - before,
                     ctx.report(), ctx.cache_stats()["resident"])
    for a, b in zip(got["mine"][0], got["ref"][0]):
        _same(a, b)
    assert got["mine"][1] == got["ref"][1] == 3
    _report_equal(got["mine"][2], got["ref"][2])
    # the second projection's own first pin is a hit in its add_call; the
    # first projection's last call finds the other's plane under its key
    assert (got["mine"][2]["resident_hits"],
            got["mine"][2]["resident_misses"]) == (3, 1)
    assert got["mine"][3] == got["ref"][3]


# ---------------------------------------------------------------------------
# APSink
# ---------------------------------------------------------------------------

def test_apsink_scope_checkpoint_restore_report():
    """A request sink under ap_request_scope: a checkpoint taken after one
    call, a second call, a restore, then the report equals the reference
    sink's after the same sequence (and the context's default sink saw
    nothing)."""
    w = _dense(10)
    xs = [np.random.default_rng(11 + i).normal(size=(T, D_IN))
          .astype(np.float32) for i in range(2)]
    ref, mine = _ctxs()
    reps = []
    for ctx, mod, arr in ((ref, rapc, jnp.asarray),
                          (mine, apc, torch.from_numpy)):
        lin = mod.APLinear(*map(arr, _ref_ternary(w)), label="p")
        sink = mod.APSink(radix=3)
        with mod.ap_request_scope(sink):
            lin(arr(xs[0]), ctx)
            ck = sink.checkpoint()
            lin(arr(xs[1]), ctx)
            assert sink.n_graphs == 2 and ctx.n_graphs == 2
            sink.restore(ck)
            assert ctx.n_graphs == 1
            rep = ctx.report()
        assert ctx.n_graphs == 0
        reps.append((rep, sink.report(), ck[0]))
    (rrep, rsink, rck), (mrep, msink, mck) = reps
    assert mck == rck
    _report_equal(mrep, rrep)
    _report_equal(msink, rsink)


# ---------------------------------------------------------------------------
# ap_moe_dispatch
# ---------------------------------------------------------------------------

E, D, FF = 3, 12, 10


def _moe_inputs(t, k, seed=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, D)).astype(np.float32)
    eids = np.array([rng.permutation(E)[:k] for _ in range(t)],
                    np.int32).reshape(t, k)
    gates = rng.uniform(0.1, 1, (t, k)).astype(np.float32)
    w = {n: rng.normal(size=shape).astype(np.float32) for n, shape in
         (("w1", (E, D, FF)), ("w3", (E, D, FF)), ("w2", (E, FF, D)))}
    return x, eids, gates, w


def _dispatch(ctx, mod, arr, act, x, eids, gates, w):
    """Each expert's projections from the reference's ternarization (the
    context's ``expert_linears`` ternarizes on its own side, see
    test_aplinear_from_dense_matches_reference)."""
    lins = [[mod.APLinear(*map(arr, _ref_ternary(w[n][e])),
                          label=f"moe.{n}.e{e}",
                          store=ctx.runtime.pool.resident)
             for e in range(E)] for n in ("w1", "w3", "w2")]
    return mod.ap_moe_dispatch(ctx, arr(x), arr(eids), arr(gates), *lins,
                               act)


def test_expert_linears_cache():
    """One APLinear per expert, cached on (key, id(stack)); a fresh stack
    tensor (as every decode step's unbind view is) builds them again."""
    _, mine = _ctxs()
    w = torch.from_numpy(_moe_inputs(2, 1)[3]["w1"])
    lins = mine.expert_linears("moe.w1", w, label="moe.w1.")
    assert [lin.label for lin in lins] == [f"moe.w1.e{e}" for e in range(E)]
    assert mine.expert_linears("moe.w1", w) is lins
    again = mine.expert_linears("moe.w1", w[:])
    assert again is not lins and mine.cache_stats()["linears"] == 2


@pytest.mark.parametrize("act", ["relu", "silu"])
def test_ap_moe_dispatch_matches_reference(act):
    """Top-2 of 3 experts over 5 tokens: the combine, the two graphs and
    their accounting as the reference's, bit for bit with relu.  silu is
    torch's and XLA's own (they differ in the last bit of about a quarter
    of values), so its outputs are held within rtol 1e-6 and its integer
    accounting exactly."""
    x, eids, gates, w = _moe_inputs(5, 2)
    ref, mine = _ctxs()
    want = _dispatch(ref, rapc, jnp.asarray, getattr(jax.nn, act),
                     x, eids, gates, w)
    got = _dispatch(mine, apc, torch.from_numpy, getattr(F, act),
                    x, eids, gates, w)
    assert got.shape == (5, D) and got.dtype == torch.float32
    if act == "relu":
        _same(got, want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)
    assert mine.n_graphs == ref.n_graphs == 2
    _report_equal(mine.report(), ref.report())


@pytest.mark.parametrize("t,k", [(0, 2), (4, 0)])
def test_ap_moe_dispatch_empty_runs_no_graph(t, k):
    x, eids, gates, w = _moe_inputs(t, k)
    ref, mine = _ctxs()
    want = _dispatch(ref, rapc, jnp.asarray, jax.nn.relu, x, eids, gates, w)
    got = _dispatch(mine, apc, torch.from_numpy, F.relu, x, eids, gates, w)
    assert got.shape == (t, D) and not got.any()
    _same(got, want)
    assert mine.n_graphs == ref.n_graphs == 0


def test_ap_moe_dispatch_validates():
    _, mine = _ctxs()
    lin = apc.APLinear.from_dense(torch.from_numpy(_dense(13, D, D)))
    x = torch.zeros((2, D))
    ids = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="disagree"):
        apc.ap_moe_dispatch(mine, x, ids, ids.float(), [lin], [lin], [],
                            F.relu)
    with pytest.raises(ValueError, match="at least one expert"):
        apc.ap_moe_dispatch(mine, x, ids, ids.float(), [], [], [], F.relu)


# ---------------------------------------------------------------------------
# The plain route and the serving hooks
# ---------------------------------------------------------------------------

def test_plain_ap_projections_equal_ap_route():
    """Under plain_ap_projections() a projection runs no graph and charges
    nothing, and gives the AP route's output bit for bit."""
    w = _dense(14, 40, 9)
    x = torch.from_numpy(np.random.default_rng(15).normal(size=(4, 40))
                         .astype(np.float32))
    _, mine = _ctxs()
    lin = apc.APLinear.from_dense(torch.from_numpy(w), label="p")
    got = lin(x, mine)
    n_graphs = mine.n_graphs
    with apc.plain_ap_projections():
        plain = lin(x, mine)
    assert mine.n_graphs == n_graphs == 1
    assert torch.equal(got, plain)
    # and the plain accumulator is the integer product itself
    x_int, s = mine.quantize(x)
    acc = x_int.long() @ lin.w_ter.long()
    assert torch.equal(plain, acc.float() * s * lin.w_scale[None, :])


def test_current_ap_context_and_scopes():
    _, mine = _ctxs()
    assert apc.current_ap_context() is None
    with apc.ap_serving(mine) as ctx:
        assert apc.current_ap_context() is ctx is mine
        sink = apc.APSink()
        with apc.ap_request_scope(sink) as s:
            assert s is sink and mine._sink() is sink
        assert mine._sink() is mine._default_sink
    assert apc.current_ap_context() is None
    assert layers.N_MASKED_MAC == 4
