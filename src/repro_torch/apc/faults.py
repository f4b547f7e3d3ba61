"""Device fault modeling for the MvCAM bank: injection, detection, recovery.

The paper's arrays are memristive; the related work the repo cites (the AP
tutorial, arXiv:2203.00662, and the CIM-memristor survey, arXiv:1907.07898)
both name device non-idealities — stuck-at cells, write-endurance wear-out,
transient write failures, whole-array loss — as the obstacle between an AP
simulation and an AP deployment.  This module is the stack's fault layer:

- :class:`FaultConfig` / :class:`FaultModel` — a **seeded, deterministic**
  fault injector.  Stuck-at-digit cells are a fixed per-(array, row, col)
  map drawn once per array from ``seed`` (values drawn in ``[0, radix]``,
  so a cell can be stuck *between* levels — an out-of-range digit);
  transient write flips are redrawn per launch attempt (so a retry on the
  same array can succeed); wear counters accumulate write cycles per array
  and optionally accelerate the flip rate (``wear_ref``); whole-array
  failures retire arrays outright (``dead_arrays``, or dynamically after
  ``retire_after`` detected faults).
- :class:`FaultDetected` — the detection surface, carrying the failing
  ``(node, block, array)`` coordinates up through pool -> runtime -> serve.
- :func:`expected_checksum` — the mod-r row checksum kept beside each
  written block; the pool verifies each stored block against it by
  running the IR-compiled checksum fold
  (:func:`repro_torch.apc.lower.compile_checksum`) over the stored digits,
  so detection costs honest compare/write cycles.

Everything is inert unless a :class:`FaultConfig` is installed on the
pool — either programmatically (``ArrayPool(faults=...)``) or via the
``REPRO_AP_FAULTS`` env toggle (rates from ``REPRO_AP_FAULT_*``).  With
faults off, every execution path is bit-identical to a pool without this
module (the zero-overhead guarantee tests pin).
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np

__all__ = ["FaultConfig", "FaultDetected", "FaultModel", "faults_enabled",
           "fault_config_from_env", "expected_checksum", "validate_digits"]


def faults_enabled() -> bool:
    """The ``REPRO_AP_FAULTS`` env knob: when truthy, every
    :class:`~repro_torch.apc.pool.ArrayPool` constructed without an explicit
    ``faults=`` config installs :func:`fault_config_from_env`."""
    return os.environ.get("REPRO_AP_FAULTS", "0").lower() in (
        "1", "true", "yes", "on")


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return default if v is None or v == "" else float(v)


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v is None or v == "" else int(v)


class FaultDetected(RuntimeError):
    """A stored digit block failed verification (checksum mismatch or an
    out-of-range digit) and recovery did not absorb it at this layer.

    Carries the failing coordinates so each recovery tier can act on its
    own scope: the pool retries/remaps per ``block``/``array``, the
    runtime re-executes per ``node``, the serve layer isolates per
    request."""

    def __init__(self, msg: str, *, node: int | None = None,
                 block: int | None = None, array: int | None = None):
        super().__init__(msg)
        self.node = node
        self.block = block
        self.array = array


@dataclass(frozen=True)
class FaultConfig:
    """Knobs of the seeded device fault model.

    - ``stuck_rate`` — per-cell probability of a permanently stuck digit
      cell (fixed map per array; stuck values drawn in ``[0, radix]``,
      where value ``radix`` models a cell stuck between levels).
    - ``flip_rate`` — per-cell per-write probability of a transient write
      flip (redrawn every launch attempt; a retry can land clean).
    - ``dead_arrays`` — array indices retired before the first launch
      (whole-array failure).
    - ``seed`` — deterministic base seed for every draw.
    - ``radix`` — the device's physical digit levels (fallback when a
      launch does not declare its program radix).
    - ``max_retries`` — per-block retry/remap attempts before the pool
      gives up and raises :class:`FaultDetected`.
    - ``retire_after`` — detected faults on one array before the pool
      retires it permanently (the bank degrades but keeps serving).
    - ``node_retries`` — whole-node re-executions
      :meth:`repro_torch.apc.runtime.Runtime.run_graph` attempts on top of the
      pool-level retries.
    - ``wear_ref`` — write-endurance reference: after an array absorbs
      ``wear_ref`` write cycles its effective flip rate scales by
      ``(1 + wear / wear_ref)`` (endurance wear-out).  ``None`` disables.
    """
    stuck_rate: float = 0.0
    flip_rate: float = 0.0
    dead_arrays: tuple[int, ...] = ()
    seed: int = 0
    radix: int = 3
    max_retries: int = 3
    retire_after: int = 4
    node_retries: int = 1
    wear_ref: int | None = None

    def __post_init__(self):
        if not 0.0 <= self.stuck_rate <= 1.0:
            raise ValueError(f"stuck_rate must be in [0, 1], "
                             f"got {self.stuck_rate}")
        if not 0.0 <= self.flip_rate <= 1.0:
            raise ValueError(f"flip_rate must be in [0, 1], "
                             f"got {self.flip_rate}")
        if self.radix < 2:
            raise ValueError(f"radix must be >= 2, got {self.radix}")
        if self.max_retries < 0 or self.node_retries < 0:
            raise ValueError("retry counts must be >= 0")
        if self.retire_after < 1:
            raise ValueError(f"retire_after must be >= 1, "
                             f"got {self.retire_after}")
        if self.wear_ref is not None and self.wear_ref < 1:
            raise ValueError(f"wear_ref must be >= 1, got {self.wear_ref}")


def fault_config_from_env() -> FaultConfig:
    """Build a :class:`FaultConfig` from the ``REPRO_AP_FAULT_*`` env
    knobs (``STUCK``/``FLIP``/``DEAD``/``SEED``/``RETRIES``/
    ``RETIRE_AFTER``)."""
    dead = tuple(int(d) for d in
                 os.environ.get("REPRO_AP_FAULT_DEAD", "").split(",") if d)
    return FaultConfig(
        stuck_rate=_env_float("REPRO_AP_FAULT_STUCK", 0.0),
        flip_rate=_env_float("REPRO_AP_FAULT_FLIP", 0.0),
        dead_arrays=dead,
        seed=_env_int("REPRO_AP_FAULT_SEED", 0),
        max_retries=_env_int("REPRO_AP_FAULT_RETRIES", 3),
        retire_after=_env_int("REPRO_AP_FAULT_RETIRE_AFTER", 4))


class FaultModel:
    """Seeded per-bank fault state: stuck maps, wear, retirement.

    One per :class:`~repro_torch.apc.pool.ArrayPool`.  All draws derive from
    ``cfg.seed`` — the stuck map of array ``a`` is a pure function of
    ``(seed, a)``, transient flips of ``(seed, a, nonce)`` where the nonce
    advances per corruption attempt — so a given pool + seed + launch
    sequence reproduces the exact same faults every run (the property the
    recovery tests and the ``ap_faults`` benchmark rely on).
    """

    def __init__(self, cfg: FaultConfig, n_arrays: int, rows: int,
                 cols: int):
        for d in cfg.dead_arrays:
            if not 0 <= d < n_arrays:
                raise ValueError(
                    f"dead array {d} outside bank of {n_arrays}")
        if len(set(cfg.dead_arrays)) >= n_arrays:
            raise ValueError("cannot retire every array at construction")
        self.cfg = cfg
        self.n_arrays = n_arrays
        self.rows = rows
        self.cols = cols
        self.retired: set[int] = set(cfg.dead_arrays)
        self.wear = [0] * n_arrays           # write cycles absorbed
        self.detections = [0] * n_arrays     # detected faults per array
        self._nonce = 0
        self._stuck: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._lock = threading.Lock()

    # -- derived state -------------------------------------------------------

    def healthy(self) -> list[int]:
        """Surviving array indices, in bank order."""
        return [a for a in range(self.n_arrays) if a not in self.retired]

    def stuck_cells(self, a: int) -> tuple[np.ndarray, np.ndarray]:
        """(mask, values) of array ``a``'s permanently stuck cells —
        lazily drawn, deterministic in ``(seed, a)``."""
        with self._lock:
            hit = self._stuck.get(a)
            if hit is None:
                rng = np.random.default_rng(
                    np.random.SeedSequence(entropy=self.cfg.seed,
                                           spawn_key=(0x5AC, a)))
                mask = rng.random((self.rows, self.cols)) \
                    < self.cfg.stuck_rate
                vals = rng.integers(0, self.cfg.radix + 1,
                                    (self.rows, self.cols)).astype(np.int8)
                hit = (mask, vals)
                self._stuck[a] = hit
            return hit

    def flip_rate(self, a: int) -> float:
        """Effective transient flip rate of array ``a`` (wear-accelerated
        when ``wear_ref`` is set)."""
        rate = self.cfg.flip_rate
        if self.cfg.wear_ref:
            rate = min(1.0, rate * (1.0 + self.wear[a] / self.cfg.wear_ref))
        return rate

    # -- injection -----------------------------------------------------------

    def corrupt(self, true_np: np.ndarray, a: int, radix: int) -> np.ndarray:
        """What array ``a`` actually stores after a write of ``true_np``:
        stuck cells override, then transient flips land a neighboring
        level (clipped into ``[0, radix]`` — the top value is out of range
        on purpose).  A fresh nonce per call makes retries independent."""
        stored = np.array(true_np, copy=True)
        r, c = stored.shape
        mask, vals = self.stuck_cells(a)
        m = mask[:r, :c]
        if m.any():
            stored[m] = vals[:r, :c][m]
        rate = self.flip_rate(a)
        if rate > 0.0:
            with self._lock:
                self._nonce += 1
                nonce = self._nonce
            rng = np.random.default_rng(
                np.random.SeedSequence(entropy=self.cfg.seed,
                                       spawn_key=(0xF11, a, nonce)))
            flips = rng.random(stored.shape) < rate
            if flips.any():
                delta = (rng.integers(0, 2, stored.shape)
                         .astype(np.int16) * 2 - 1)
                hit = stored.astype(np.int16) + delta
                stored[flips] = np.clip(hit[flips], 0, radix).astype(np.int8)
        return stored

    # -- bookkeeping ---------------------------------------------------------

    def record_write(self, a: int, n_write_cycles: int) -> None:
        """Feed the wear counter with one launch's write cycles."""
        self.wear[a] += int(n_write_cycles)

    def record_detection(self, a: int) -> bool:
        """Count one detected fault on array ``a``; returns True when this
        detection crossed ``retire_after`` and retired the array."""
        self.detections[a] += 1
        if a not in self.retired \
                and self.detections[a] >= self.cfg.retire_after:
            self.retire(a)
            return True
        return False

    def retire(self, a: int) -> None:
        """Permanently remove array ``a`` from the bank."""
        if not 0 <= a < self.n_arrays:
            raise ValueError(f"array {a} outside bank of {self.n_arrays}")
        self.retired.add(a)

    def snapshot(self) -> dict:
        """JSON-able state summary (monitoring / benchmark rows)."""
        return {
            "n_arrays": self.n_arrays,
            "retired": sorted(self.retired),
            "surviving": len(self.healthy()),
            "detections": list(self.detections),
            "wear": list(self.wear),
        }


# ---------------------------------------------------------------------------
# Detection helpers
# ---------------------------------------------------------------------------

def expected_checksum(true_np: np.ndarray, radix: int) -> np.ndarray:
    """The mod-r row checksum kept alongside each written block: the row
    sum of the *intended* digits mod ``radix``.  Any single stored cell
    differing from intent shifts its row's stored checksum by a nonzero
    amount mod r, so single-cell corruption is always caught."""
    return np.asarray(true_np).astype(np.int64).sum(axis=1) % radix


def validate_digits(digits, radix: int, *, what: str = "digits") -> None:
    """Digit-range validation at decode: every digit must lie in
    ``[0, radix)``; a stuck-between-levels cell (value ``radix``) or any
    other out-of-range value raises :class:`FaultDetected` naming the
    offending rows.  Host-side; callers gate it on an installed fault
    model so the pristine path never pays the sync."""
    d = np.asarray(digits)
    bad = (d < 0) | (d >= radix)
    if bad.any():
        rows = np.nonzero(bad.any(axis=tuple(range(1, d.ndim))))[0]
        raise FaultDetected(
            f"{what}: {int(bad.sum())} digit(s) outside [0, {radix}) in "
            f"rows {rows[:8].tolist()}{'...' if rows.size > 8 else ''}")
