"""One run of one cell: set-up, the measured window, the traced window, the
correctness check, and the result line.

Everything that belongs to one cell, configuration or metric is a file
that this module finds by its name in ``BENCHMARK.json``:

- ``portbench/configs/<config>.json``: the model (the port's
  ``ModelConfig`` fields under ``model``, its ``family`` among them) and
  how it is served (``serve``);
- ``portbench/families/<family>.py``: the port's configuration, the
  seeded weights, the plain reference and the AP graph count of a family
  of models (:mod:`portbench.families`);
- ``portbench/workloads/<cell>.json``: the traffic driver, its parameters,
  the warm-up, the traced window (``program_trace``: with the program's
  own spans and counters) and the check's sample and limits;
- ``portbench/drivers/<driver>.py``: ``run(system, traffic, seed, seconds,
  vocab)``;
- ``portbench/metrics/<metric>.py``: ``read(data) -> float | None`` for
  every metric, end-to-end or per-layer.

The program under test is ``repro_torch`` alone; this module imports it
lazily, and never JAX or the JAX package.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Spec:
    """A cell as the files under ``root`` define it."""

    def __init__(self, name: str, root: Path | None = None):
        self.root = Path(root) if root is not None else BENCH_DIR.parent
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.chips = int(entry["chips"])
        self.cell = self._json("workloads", name)
        cfg = next(c for c in bench["configs"]
                   if c["name"] == entry["config"])
        self.config = json.loads((self.root / cfg["file"]).read_text())
        self.model = self.config["model"]
        self.serve = self.config["serve"]
        self.family = self.module("families",
                                  self.model.get("family", "dense"))

        def mine(m):
            return name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.root / "portbench" / kind /
                           f"{name}.json").read_text())

    def module(self, kind: str, name: str):
        """``portbench/<kind>/<name>.py`` of this checkout, loaded."""
        path = self.root / "portbench" / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------

def _timed_engine_cls():
    """An ``Engine`` whose requests note when each step ends and each token
    reaches the host (the harness's own timestamps; nothing else
    changes)."""
    from repro_torch.serve.engine import Engine, Request

    class TimedRequest(Request):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.token_times: list[float] = []
            self.step_log: list[tuple] = []     # (end time, position, batch)

        def prefill_step(self):
            pos = self.pos
            super().prefill_step()
            self.step_log.append((time.perf_counter(), pos, self.b))

        def sample_first(self):
            super().sample_first()
            self.token_times.append(time.perf_counter())

        def decode_step(self):
            pos = self.pos
            super().decode_step()
            now = time.perf_counter()
            self.step_log.append((now, pos, self.b))
            self.token_times.append(now)

        def restore(self, ck):
            super().restore(ck)
            del self.token_times[len(self.out):]
            del self.step_log[self.n_model_steps:]

    class TimedEngine(Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.requests: dict[int, TimedRequest] = {}

        def new_request(self, prompts, n_new, cross_embeds=None):
            req = TimedRequest(self, prompts, n_new, cross_embeds)
            self.requests[id(prompts)] = req
            return req

    return TimedEngine


class System:
    """The program as the cell serves it: weights made from the seed,
    quantized and cast by the program, an ``Engine`` (on the AP route with
    its ``APServeContext``) behind a ``BatchServer``."""

    def __init__(self, spec: Spec, seed: int, device: torch.device):
        from repro_torch.models.model import cast_params
        from repro_torch.models.quant import quantize_model_params
        from repro_torch.serve import AdmissionCfg, BatchServer, ServeCfg

        from .weights import DTYPES
        self.spec, self.device = spec, device
        phases = {}
        t = time.perf_counter()
        if device.type == "cuda":
            from repro_torch.kernels import cuda_lib
            cuda_lib.build()
            for name in cuda_lib.LIBRARIES:
                cuda_lib.entry(name)
        phases["kernels"] = time.perf_counter() - t
        t = time.perf_counter()
        model = spec.model
        self.cfg = spec.family.model_config(model)
        tree = spec.family.program_tree(model, seed, device,
                                        DTYPES[model["param_dtype"]])
        params = cast_params(self.cfg, quantize_model_params(tree))
        del tree
        gc.collect()
        self._sync()
        phases["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        serve = spec.serve
        ctx = None
        if serve["route"] == "ap":
            from repro_torch.apc import APServeContext, ArrayPool, Runtime
            pool = serve["pool"]
            ctx = APServeContext(Runtime(ArrayPool(
                pool["n_arrays"], pool["rows"], pool["cols"], device=device)),
                radix=serve["radix"], x_levels=serve["x_levels"])
        traffic = spec.cell["traffic"]
        self.engine = _timed_engine_cls()(
            self.cfg, params, ServeCfg(max_len=int(traffic["max_len"])),
            ap_ctx=ctx, device=device)
        self.server = BatchServer(self.engine, admission=AdmissionCfg(
            max_inflight=int(traffic["clients"])))
        phases["engine"] = time.perf_counter() - t
        self.phases = phases

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, prompts, n_new):
        return self.server.submit(prompts, n_new)

    def timing(self, prompts) -> dict:
        req = self.engine.requests.pop(id(prompts), None)
        if req is None:
            return {"token_times": [], "steps": []}
        return {"token_times": list(req.token_times),
                "steps": list(req.step_log)}

    def close(self):
        self.server.close()
        self.engine.requests.clear()


# ---------------------------------------------------------------------------
# The traced window's instruments
# ---------------------------------------------------------------------------

# host spans of the traced run: (module, class, method, span name)
_SPANS = (("repro_torch.serve.engine", "Engine", "_step", "model step"),
          ("repro_torch.serve.engine", "Engine", "_sample", "sampling"),
          ("repro_torch.apc.layers", "APServeContext", "linear",
           "APLinear cache or build"),
          ("repro_torch.apc.layers", "APServeContext", "quantize",
           "activation quantize"),
          ("repro_torch.apc.layers", "APLinear", "add_call",
           "AP graph building"),
          ("repro_torch.serve.batcher", "WaveMerger", "run_graph",
           "wave rendezvous"),
          ("repro_torch.apc.runtime", "Runtime", "run_graph",
           "AP graph run (launches, counters)"))


class _Recorder:
    """While installed (the traced run only), notes the work of every
    program-kernel launch and every packed-ternary product (their shapes
    and row counts) around the program's calls into its kernels, and the
    host span of each call into the layers named in ``_SPANS`` (epoch ns,
    the profiler's clock), so that idle gaps get the host's activity."""

    def __init__(self):
        self.tap: list[tuple] = []
        self.matmul: list[tuple] = []
        self.spans: list[tuple] = []
        self._undo: list = []

    def _wrap(self, owner, name, fn):
        setattr(owner, name, fn)
        self._undo.append((owner, name))

    def install(self):
        import importlib

        import repro_torch.apc.pool as pool_mod
        import repro_torch.models.mlp as mlp_mod
        tap, mm = pool_mod.tap_run_program, mlp_mod.ternary_matmul_op
        self._orig = {(pool_mod, "tap_run_program"): tap,
                      (mlp_mod, "ternary_matmul_op"): mm}

        def tap_wrap(arr, *sched_and_valid, **kw):
            self.tap.append((arr.shape[1], sched_and_valid[:6],
                             sched_and_valid[6], kw.get("block_valid")))
            return tap(arr, *sched_and_valid, **kw)

        def mm_wrap(x, packed, scale, *a, **kw):
            self.matmul.append((x.shape[0], x.shape[1], packed.shape[1],
                                x.element_size()))
            return mm(x, packed, scale, *a, **kw)

        self._wrap(pool_mod, "tap_run_program", tap_wrap)
        self._wrap(mlp_mod, "ternary_matmul_op", mm_wrap)
        for mod, cls, meth, label in _SPANS:
            owner = getattr(importlib.import_module(mod), cls)
            fn = getattr(owner, meth)
            self._orig[(owner, meth)] = fn

            def spanned(*a, _fn=fn, _label=label, **kw):
                t0 = time.time_ns()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.spans.append((_label, t0, time.time_ns()))
            self._wrap(owner, meth, spanned)

    def uninstall(self):
        for owner, name in reversed(self._undo):
            setattr(owner, name, self._orig[(owner, name)])
        self._undo = []

    def tap_launches(self) -> list[tuple[int, int, int]]:
        """``(rows, cols, cells a row)`` of each recorded launch."""
        from .work import program_cells
        cells: dict[int, int] = {}
        out = []
        for cols, sched, n_valid, block_valid in self.tap:
            cmp_cols, _keys, key_valid, _h, wr_cols, _v = sched
            c = cells.get(id(cmp_cols))
            if c is None:
                c = program_cells((key_valid.sum(1)).tolist(),
                                  (cmp_cols >= 0).sum(1).tolist(),
                                  (wr_cols >= 0).sum(1).tolist())
                cells[id(cmp_cols)] = c
            rows = int(n_valid if block_valid is None
                       else block_valid.sum())
            out.append((rows, cols, c))
        return out


def _device_events(prof):
    """Device activity ``[(name, start_ns, end_ns)]`` of a profile:
    kernels, copies and sets."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]


def _busy_and_gaps(kernels):
    """Union of the kernels' intervals: busy seconds and the idle gaps
    ``[(start_ns, end_ns)]`` between them."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-9, gaps


def _idle_by_activity(gaps, spans) -> list:
    """Idle seconds summed by what the host was doing at each gap's middle
    (the innermost recorded span; the latest to start), most first."""
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]
    total: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        name = "outside the traced layers (serve loop)"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(-1, i - 1 - 512), -1):
            if spans[j][2] >= mid:
                name = spans[j][0]
                break
        total[name] = total.get(name, 0.0) + (g1 - g0) * 1e-9
    return sorted(total.items(), key=lambda kv: -kv[1])


def _program_counters() -> dict:
    """The program's registry counters (its only whole-number
    instruments: gauges read as floats, histograms as dicts)."""
    from repro_torch.apc.metrics import get_registry
    return {k: v for k, v in get_registry().snapshot().items()
            if type(v) is int}


def _program_spans(tracer, stop_ns: int) -> list[dict]:
    """The program's host spans on the profiler's clock, those begun
    before ``stop_ns`` and cut there, in order of their starts."""
    from repro_torch.apc.trace import HOST_PID, SpanRecord
    out = []
    for r in list(tracer.events):
        if not isinstance(r, SpanRecord) or r.pid != HOST_PID:
            continue
        start, end = tracer.epoch_ns(r)
        if start < stop_ns:
            out.append({"name": r.name, "cat": r.cat, "thread": r.thread,
                        "parent": r.parent, "args": r.args,
                        "start_ns": start, "end_ns": min(end, stop_ns)})
    return sorted(out, key=lambda sp: sp["start_ns"])


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def _window_data(spec: Spec, window: dict) -> dict:
    recs = window["records"]
    done = [r for r in recs if r["error"] is None]
    return {"window_s": window["t_end"] - window["t0"],
            "tokens": sum(int(r["tokens"].size) for r in done),
            "token_times": [r["token_times"] for r in done],
            "records": recs, "model": spec.model, "cell": spec.cell}


def _sample(spec: Spec, seed: int, records: list) -> list:
    """The requests the check compares, drawn from the seed, each with
    every row: a fault in one row or in half of the batch cannot fall
    outside the sample."""
    chk = spec.cell["check"]
    done = [r for r in records if r["error"] is None]
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), 7]))
    pick = rng.choice(len(done), size=min(len(done), chk["requests"]),
                      replace=False)
    out = []
    return [(done[i]["prompts"], done[i]["tokens"])
            for i in sorted(pick.tolist())]


def _forbidden_modules() -> list[str]:
    top = {k.split(".")[0] for k in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def run(spec: Spec, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float | None = None,
        control: str | None = None, log=None) -> dict | None:
    """Set up, measure, check; the result line's object, or None when a
    forbidden module was loaded (named on standard error).  With
    ``control`` (``"tf32"``, ``"fp8"``) the reference in that precision
    takes the program's place in the check: ``correct`` is the control's
    verdict, and ``readings`` holds both sides' numbers."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell
    system = System(spec, seed, device)
    driver = spec.module("drivers", cell["driver"])
    vocab = spec.model["vocab"]
    t = time.perf_counter()
    driver.run(system, cell["warmup"], seed, 0.0, vocab)
    system._sync()
    system.phases["warm-up"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    log("setup: " + ", ".join(f"{k} {v:.3f} s"
                              for k, v in system.phases.items()))
    rec = None
    prof = None
    tracer = None
    program_scope = contextlib.ExitStack()
    if trace:
        from repro_torch.kernels.tap_pass.kernel import launch_counts as tl
        from repro_torch.kernels.ternary_matmul.kernel import \
            launch_counts as ml
        counts0 = {**tl, **ml}
        waves0 = system.server.n_waves
        rec = _Recorder()
        rec.install()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
            else torch.profiler.ProfilerActivity.CPU])
        if cell.get("program_trace"):
            # the program's own spans and counters, for the cells that ask:
            # its tracer costs the AP route's host time
            from repro_torch.apc.trace import Tracer, tracing
            counters0 = _program_counters()
            tracer = program_scope.enter_context(tracing(Tracer()))
        prof.start()
        seconds = float(cell["trace_seconds"])
    setup_s = time.perf_counter() - t_start
    window = driver.run(system, cell["traffic"], seed, seconds, vocab)
    system._sync()
    data = _window_data(spec, window)
    data["setup_s"] = setup_s
    if trace:
        stop_ns = time.time_ns()
        prof.stop()
        program_scope.close()
        rec.uninstall()
        if tracer is not None:
            data["program_spans"] = _program_spans(tracer, stop_ns)
            data["program_counters"] = {
                k: v - counters0.get(k, 0)
                for k, v in _program_counters().items()}
        kernels = _device_events(prof)
        busy_s, gaps = _busy_and_gaps(kernels)
        data.update(
            busy_s=busy_s, kernels=[(n, (e - s) * 1e-9)
                                    for n, s, e in kernels],
            tap_launches=rec.tap_launches(), matmul_launches=rec.matmul,
            steps=[(pos, b) for r in window["records"]
                   for _, pos, b in r["steps"]],
            waves=system.server.n_waves - waves0,
            launches={k: v - counts0[k] for k, v in {**tl, **ml}.items()})
        by_name: dict[str, float] = {}
        for n, d in data["kernels"]:
            by_name[n] = by_name.get(n, 0.0) + d
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[n[:200], s] for n, s in top_ops],
                     "idle_gaps": [[n, s] for n, s in _idle_by_activity(
                         gaps, rec.spans)[:10]]}
        del prof
    system.close()
    records = window["records"]
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = spec.module("metrics", m["name"]).read(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if device.type == "cuda" else 0)}
    if trace:
        dev.update(busy_s=data["busy_s"], window_s=data["window_s"])
    # the check: the program's state freed first, the reference after
    failed = sum(r["error"] is not None for r in records)
    samples = _sample(spec, seed, records)
    del system, window
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from .reference.check import read_gaps
    t = time.perf_counter()
    read = read_gaps(spec.family, spec.model, spec.serve, seed, device,
                     samples, control=control,
                     cache_len=cell["traffic"]["max_len"])
    log(f"check: {read['tokens']} served tokens compared in "
        f"{time.perf_counter() - t:.3f} s; widest gap {read['logit_gap']!r}, "
        f"mean gap {read['mean_gap']!r}, mismatch {read['mismatch']!r}")
    judged = read
    if control:
        # the control takes the program's place: its readings are judged
        judged = {k[len("control_"):]: v for k, v in read.items()
                  if k.startswith("control_")}
        log(f"control ({control}) in the program's place: widest gap "
            f"{judged['logit_gap']!r}, mean gap {judged['mean_gap']!r}, "
            f"mismatch {judged['mismatch']!r}")
    checks = {}
    ok = failed == 0 and bool(samples)
    for name, limit in cell["check"]["limits"].items():
        checks[name] = {"value": judged[name], "limit": limit}
        ok = ok and limit is not None and judged[name] <= limit
    if spec.serve["route"] == "ap":
        reports = [r["ap_report"] or {} for r in records
                   if r["error"] is None]
        # every step of every request runs the family's AP graphs: a
        # route that skips the simulator gives the same logits, so the
        # graphs are counted too
        tr = cell["traffic"]
        want = spec.family.ap_graphs_per_step(spec.model) * (
            tr["prompt_len"] + tr["new_tokens"] - 1)
        off = max((abs(rep.get("n_graphs", 0) - want) for rep in reports),
                  default=want)
        checks["ap_graphs_off"] = {"value": off, "limit": 0}
        ok = ok and off == 0
        # the modelled counters that do not depend on the data: every
        # request of the cell's shape reads the frozen count
        frozen = cell["check"]["ap_counters"]
        off = 0
        for key, count in frozen.items():
            seen = sorted({rep.get(key) for rep in reports},
                          key=lambda v: (v is None, v))
            log(f"ap counter {key} {seen!r} frozen {count!r}")
            off += sum(rep.get(key) != count for rep in reports)
        checks["ap_counters_off"] = {"value": off, "limit": 0}
        ok = ok and off == 0 and bool(reports)
    checks["failed_requests"] = {"value": failed, "limit": 0}
    # once the window has closed and the family's reference has run
    bad = _forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return None
    for name, c in checks.items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    out = {"correct": bool(ok), "attempted": len(records), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = breakdown
    if control:
        out["readings"] = read
    out["checks"] = checks
    return out
