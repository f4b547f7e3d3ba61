"""Slot records: the program kernel's compact form of a schedule.

The CUDA program kernel (``csrc/tap_program.cu``) does not read the six
dense schedule tensors.  The host encodes them once per (program, column
count) into one fixed-size record per slot, int32 words, little-endian:

- word 0, the header: the number of valid keys ``nk`` in bits 0-15 and the
  histogram flag in bit 16 (set only where ``nk > 0``);
- ``C`` compare columns as uint16;
- ``K`` x ``C`` key digits as int8, key-major, the valid keys first;
- ``W`` write columns as uint16, in schedule order;
- ``W`` write values as int8;

each field starting on a word, the record padded to a multiple of four
words (16 bytes, one ``cp.async``).  In the *wide* form of the unrolled
kernels every column is a whole word and every key digit and write value
is a word holding it in all four bytes, so the kernel reads each as it is,
with no shift, mask or byte spread.  A column outside ``[0, cols)`` -- the
-1 padding, or one the host did not check -- becomes the *dummy column*
``cols``: the kernel keeps one extra tile column of don't-care digits
there, so a compare against it always matches, and a write to it carries
the value -1 and changes nothing.  A slot with no valid key writes
unconditionally, as in the dense form.  :func:`decode_records` gives the
dense tensors back.

The wide record's last word holds the slot's flags as byte masks, so the
unrolled kernels need no branch per slot: bit 7 of every byte where the
slot has no valid key, bit 6 where its histogram flag is on.

Two layouts: the program's own (K = its most valid keys in a slot, C and W
its dense widths), packed, for the general kernel, and the fixed (1, 3, 3)
or (1, 4, 3), wide, of the unrolled kernels, which take programs with at most one
key, four compare columns and three distinct write columns per slot and
``pack == 1`` -- every program on the main paths (:func:`choose_layout`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_COLS = 65534                 # uint16 columns, the dummy column included
FAST_LAYOUTS = ((1, 3, 3), (1, 4, 3))   # (K, C, W) of the unrolled kernels
KIND_GENERAL, KIND_FAST_C3, KIND_FAST_C4 = 0, 1, 2
CHUNK_BYTES = 2048               # records staged per shared-memory buffer


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Layout:
    """Word offsets of a record's fields for (K, C, W): packed (uint16
    columns, int8 digits) or wide (one word per column, digit or value)."""
    K: int
    C: int
    W: int
    wide: bool = False

    def _words(self, n: int, per_word: int) -> int:
        return n if self.wide else _ceil(n, per_word)

    @property
    def keys_at(self) -> int:
        return 1 + self._words(self.C, 2)

    @property
    def wcols_at(self) -> int:
        return self.keys_at + self._words(self.K * self.C, 4)

    @property
    def wvals_at(self) -> int:
        return self.wcols_at + self._words(self.W, 2)

    @property
    def words(self) -> int:
        return _ceil(self.wvals_at + self._words(self.W, 4), 4) * 4


@dataclass(frozen=True)
class Records:
    """A program's records on one device, with what the launch needs."""
    records: object              # int32 [slots padded to chunk_slots, words]
    layout: Layout
    kind: int                    # KIND_*: which kernel instantiation
    n_slots: int
    chunk_slots: int
    n_hist_keys: int             # sum over slots of nk, where hist is on


def _host(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _valid_keys(key_valid: np.ndarray) -> np.ndarray:
    return key_valid.astype(bool).sum(axis=1)


def choose_layout(sched, pack: int) -> tuple[int, Layout]:
    """The kernel kind and record layout for a schedule (numpy arrays).

    The unrolled kernels take ``pack == 1`` schedules with at most one
    valid key, four compare columns and three write columns per slot, the
    valid write columns of a slot distinct (their writes then commute);
    any other schedule takes the general kernel, in its own layout."""
    cmp_cols, keys, key_valid, _, wr_cols, _ = sched
    C, W = cmp_cols.shape[1], wr_cols.shape[1]
    nk = _valid_keys(key_valid)
    max_nk = int(nk.max()) if nk.size else 0
    if pack == 1 and max_nk <= 1 and C <= 4 and W <= 3:
        wc = np.where(wr_cols >= 0, wr_cols, -1 - np.arange(W)[None, :])
        distinct = all((wc[:, i] != wc[:, j]).all()
                       for i in range(W) for j in range(i + 1, W))
        if distinct:
            if C <= 3:
                return KIND_FAST_C3, Layout(*FAST_LAYOUTS[0], wide=True)
            return KIND_FAST_C4, Layout(*FAST_LAYOUTS[1], wide=True)
    return KIND_GENERAL, Layout(max(1, max_nk), C, W)


def encode_records(sched, cols: int, layout: Layout) -> np.ndarray:
    """int32 [S, layout.words] records of the six dense schedule arrays
    for a tile of ``cols`` columns."""
    if cols > MAX_COLS:
        raise ValueError(f"{cols} columns: the records hold at most "
                         f"{MAX_COLS}")
    cmp_cols, keys, key_valid, hist_flag, wr_cols, wr_vals = (
        np.asarray(t) for t in sched)
    S, C = cmp_cols.shape
    K, W = keys.shape[1], wr_cols.shape[1]
    Kt, Ct, Wt = layout.K, layout.C, layout.W
    kv = key_valid.astype(bool)
    nk = kv.sum(axis=1)
    if (nk.size and nk.max() > Kt) or C > Ct or W > Wt:
        raise ValueError(f"schedule (K={int(nk.max(initial=0))}, C={C}, "
                         f"W={W}) does not fit the layout {layout}")

    cmp = cmp_cols.astype(np.int64)
    ccol = np.full((S, Ct), cols, np.int64)
    ccol[:, :C] = np.where((cmp >= 0) & (cmp < cols), cmp, cols)
    order = np.argsort(~kv, axis=1, kind="stable")     # valid keys first
    kc = np.take_along_axis(keys.astype(np.int8), order[:, :, None], axis=1)
    kc = np.where((np.arange(K) < nk[:, None])[:, :, None], kc, 0)
    kt = np.zeros((S, Kt, Ct), np.int8)
    kt[:, :min(K, Kt), :C] = kc[:, :Kt]
    wcl = wr_cols.astype(np.int64)
    w_ok = (wcl >= 0) & (wcl < cols)
    wcol = np.full((S, Wt), cols, np.int64)
    wcol[:, :W] = np.where(w_ok, wcl, cols)
    wval = np.full((S, Wt), -1, np.int8)
    wval[:, :W] = np.where(w_ok, wr_vals.astype(np.int8), -1)
    hist = hist_flag.astype(bool) & (nk > 0)
    header = nk.astype(np.uint32) | (hist.astype(np.uint32) << 16)

    buf = np.zeros((S, layout.words * 4), np.uint8)

    def put(word: int, arr: np.ndarray) -> None:
        b = np.ascontiguousarray(arr).view(np.uint8).reshape(S, -1)
        buf[:, 4 * word:4 * word + b.shape[1]] = b

    put(0, header.astype("<u4")[:, None])
    if layout.wide:
        def spread(digits):            # the byte in all four bytes
            return digits.view(np.uint8).astype("<u4") * 0x01010101

        put(1, ccol.astype("<u4"))
        put(layout.keys_at, spread(kt.reshape(S, Kt * Ct)))
        put(layout.wcols_at, wcol.astype("<u4"))
        put(layout.wvals_at, spread(wval))
        flags = (np.where(nk == 0, 0x80808080, 0)
                 | np.where(hist, 0x40404040, 0))
        put(layout.words - 1, flags.astype("<u4")[:, None])
    else:
        put(1, ccol.astype("<u2"))
        put(layout.keys_at, kt.reshape(S, Kt * Ct))
        put(layout.wcols_at, wcol.astype("<u2"))
        put(layout.wvals_at, wval)
    return buf.view("<i4")


def decode_records(records: np.ndarray, cols: int, layout: Layout
                   ) -> tuple[np.ndarray, ...]:
    """The dense (cmp_cols, keys, key_valid, hist_flag, wr_cols, wr_vals)
    of ``records`` at the layout's widths: the dummy column back to -1
    (its write value to 0), the valid keys first."""
    S = records.shape[0]
    buf = np.ascontiguousarray(records).view(np.uint8).reshape(S, -1)
    Kt, Ct, Wt = layout.K, layout.C, layout.W

    def get(word: int, n: int, dtype) -> np.ndarray:
        size = np.dtype(dtype).itemsize
        return np.ascontiguousarray(
            buf[:, 4 * word:4 * word + n * size]).view(dtype)

    header = get(0, 1, "<u4")[:, 0]
    nk = (header & 0xFFFF).astype(np.int64)
    if layout.wide:
        ccol = get(1, Ct, "<u4").astype(np.int32)
        keys = get(layout.keys_at, Kt * Ct, "<u4").astype(np.uint8).view(
            np.int8).reshape(S, Kt, Ct)
        wcol = get(layout.wcols_at, Wt, "<u4").astype(np.int32)
        wval = get(layout.wvals_at, Wt, "<u4").astype(np.uint8).view(np.int8)
    else:
        ccol = get(1, Ct, "<u2").astype(np.int32)
        keys = get(layout.keys_at, Kt * Ct, np.int8).reshape(S, Kt, Ct)
        wcol = get(layout.wcols_at, Wt, "<u2").astype(np.int32)
        wval = get(layout.wvals_at, Wt, np.int8)
    return (np.where(ccol == cols, -1, ccol).astype(np.int32),
            keys.copy(), np.arange(Kt)[None, :] < nk[:, None],
            ((header >> 16) & 1).astype(bool),
            np.where(wcol == cols, -1, wcol).astype(np.int32),
            np.where(wcol == cols, 0, wval).astype(np.int8))


def build_records(sched, cols: int, pack: int) -> Records:
    """Host records of a schedule (numpy or tensors), padded with no-op
    slots to whole chunks; ``records`` is a numpy array here."""
    host = tuple(_host(t) for t in sched)
    kind, layout = choose_layout(host, pack)
    recs = encode_records(host, cols, layout)
    n_slots = recs.shape[0]
    chunk = max(1, CHUNK_BYTES // (4 * layout.words) // pack) * pack
    pad = _ceil(max(n_slots, 1), chunk) * chunk - n_slots
    if pad:
        noop = encode_records(
            (np.full((pad, layout.C), -1, np.int32),
             np.zeros((pad, layout.K, layout.C), np.int8),
             np.zeros((pad, layout.K), bool), np.zeros(pad, bool),
             np.full((pad, layout.W), -1, np.int32),
             np.zeros((pad, layout.W), np.int8)), cols, layout)
        recs = np.concatenate([recs, noop])
    nk = _valid_keys(host[2])
    n_hist = int((nk * (host[3].astype(bool) & (nk > 0))).sum())
    return Records(recs, layout, kind, n_slots, chunk, n_hist)
