"""Informativeness filters: mutual-information (mif0) and random.

The port's own copy of ``ipk_tpu/core/filter.py``: only its imports differ,
so numerics, ordering, formats and messages stay those of the reference.

Counterpart of ``ipk/src/filter.cpp``. Filter values only determine the
*serialization order* of the database — nothing is dropped at build time
(``--mu`` moved to EPIK; ``filter.cpp`` + CHANGELOG v0.5.0). The DB is sorted
ascending by filter value: mif0 values are negated mutual information, so
ascending = most informative first (``db_builder.cpp:281-284``).

mif0 math replicated from ``filter.cpp:60-119`` (all in float64, as the
reference uses double):

    S_w        = Σ_entries min(10^log_score, 1) + (N - |entries|) * threshold
    H(c|B_w=1) = N * shannon(threshold/S_w)
                 + Σ_entries [shannon(s_i/S_w) - shannon(threshold/S_w)]
    fv         = S_w * (H(c|B_w=1) - log2(N))

with shannon(x) = -x*log2(x), N = total node count of the original tree
(``db_builder.cpp:261``), threshold = (omega/sigma)^k in linear space.

The random filter replicates libstdc++'s ``std::default_random_engine(42)``
(= minstd_rand0) + ``uniform_real_distribution<double>(0,1)`` stream
(``filter.cpp:133-147``), verified against compiled libstdc++ output. Caveat:
the reference assigns values in C++ hash-map iteration order, which is
implementation-defined; we assign in ascending-key order (documented
deviation — the reference's order is not reproducible even across its own
builds with different hash maps).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

__all__ = ["score_threshold", "logscore_to_score", "mif0_filter_values",
           "random_filter_values", "minstd0_uniform_stream", "sort_order"]

def _load_native() -> Optional[ctypes.CDLL]:
    """Threaded C++ mif0 (native/mif0_filter.cpp, ulp-close to the numpy
    path), built on demand with portable flags;
    numpy fallback when the toolchain is unavailable or IPK_TPU_NO_NATIVE
    is set (checked on every call — utils/native.py)."""
    from ..utils.native import load_native_lib
    lib = load_native_lib("libmif0_filter.so", extra_flags=["-pthread"])
    if lib is None or getattr(lib, "_ipk_typed", False):
        return lib
    lib.ipk_mif0_entries.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32]
    lib.ipk_range_gather_apply.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int32]
    lib._ipk_typed = True
    return lib


def score_threshold(omega: float, sigma: int, k: int) -> float:
    """(omega/sigma)^k in linear space (``i2l::score_threshold`` via
    ``db_builder.cpp:260,640``)."""
    return float((np.float64(omega) / np.float64(sigma)) ** k)


def logscore_to_score(log_score: np.ndarray) -> np.ndarray:
    """min(10^x, 1.0) (``filter.cpp:20-23``)."""
    return np.minimum(np.power(10.0, np.asarray(log_score, dtype=np.float64)),
                      1.0)


def _shannon(x: np.ndarray) -> np.ndarray:
    return -x * np.log2(x)


def mif0_filter_values(scores: np.ndarray, mask: np.ndarray,
                       total_num_groups: int, threshold: float) -> np.ndarray:
    """Vectorized mif0 over the dense accumulator.

    scores: [B, K] f32 log10 scores (entries where mask), mask: [B, K] bool.
    Returns fv[K] float64; undefined (arbitrary) where a key has no entries.
    """
    N = np.float64(total_num_groups)
    thr = np.float64(threshold)
    lin = np.where(mask, logscore_to_score(scores), 0.0)
    cnt = mask.sum(axis=0, dtype=np.float64)
    score_sum = lin.sum(axis=0, dtype=np.float64) + (N - cnt) * thr
    with np.errstate(divide="ignore", invalid="ignore"):
        tt = _shannon(thr / score_sum)
        tv = np.where(mask, _shannon(lin / score_sum), 0.0)
        HcBw1 = N * tt + (tv.sum(axis=0) - cnt * tt)
        fv = score_sum * (HcBw1 - np.log2(N))
    return fv


def mif0_filter_values_entries(entry_scores: np.ndarray,
                               entry_key_index: Optional[np.ndarray],
                               num_keys: int,
                               total_num_groups: int,
                               threshold: float,
                               offsets: Optional[np.ndarray] = None
                               ) -> np.ndarray:
    """mif0 over a compacted entry list (for the sparse/large-k path).

    entry_scores: [E] f32 log10; entry_key_index: [E] int — index of the key
    each entry belongs to; returns fv[num_keys] float64.

    When ``entry_key_index`` is non-decreasing (every production call site:
    extraction emits entries key-major) the threaded C++ implementation
    (``native/mif0_filter.cpp``) is used — same accumulation order as the
    numpy expression below; values agree to ~2 ulp (numpy's SIMD pow/log2
    round differently from libm in the last bit; the DB's f32 filter column
    absorbs it — committed goldens are byte-identical either way). The reference's filter loop is
    sequential (``filter.cpp:66-116``); this threaded pass is one of the
    places the rebuild buys back host wall time (~25x measured at 8M
    entries).
    """
    N = np.float64(total_num_groups)
    thr = np.float64(threshold)
    lib = _load_native()
    if lib is not None and num_keys > 0:
        if offsets is None:
            entry_key_index = np.asarray(entry_key_index)
            counts = np.bincount(entry_key_index, minlength=num_keys)
            # grouped layout is valid only if indices are non-decreasing
            if (len(counts) == num_keys
                    and (np.diff(entry_key_index) >= 0).all()):
                offsets = np.zeros(num_keys + 1, dtype=np.int64)
                np.cumsum(counts, out=offsets[1:])
        if offsets is not None:
            offsets = np.ascontiguousarray(offsets, dtype=np.int64)
            scores32 = np.ascontiguousarray(entry_scores, dtype=np.float32)
            fv = np.empty(num_keys, dtype=np.float64)
            from ..utils.threads import host_threads
            nthreads = host_threads("IPK_TPU_FILTER_THREADS")
            lib.ipk_mif0_entries(
                scores32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                np.int64(num_keys), float(N), float(thr),
                fv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                np.int32(nthreads))
            return fv
    if entry_key_index is None:
        # numpy fallback from a grouped layout: expand the offsets
        entry_key_index = np.repeat(np.arange(num_keys, dtype=np.int64),
                                    np.diff(offsets))
    lin = logscore_to_score(entry_scores)
    cnt = np.bincount(entry_key_index, minlength=num_keys).astype(np.float64)
    ssum = np.bincount(entry_key_index, weights=lin, minlength=num_keys)
    score_sum = ssum + (N - cnt) * thr
    with np.errstate(divide="ignore", invalid="ignore"):
        tt = _shannon(thr / score_sum)
        tv_sum = np.bincount(entry_key_index,
                             weights=_shannon(lin / score_sum[entry_key_index]),
                             minlength=num_keys)
        HcBw1 = N * tt + (tv_sum - cnt * tt)
        fv = score_sum * (HcBw1 - np.log2(N))
    return fv


_MINSTD_M = np.uint64(2147483647)
_MINSTD_A = np.uint64(16807)
_MINSTD_R = np.float64(2147483646.0)   # engine range + 1
_MINSTD_BLOCK = 1 << 17                # engine steps per vector block
_minstd_pows: Optional[np.ndarray] = None


def _minstd_power_table() -> np.ndarray:
    """``[a^1, a^2, ..., a^B] mod m`` built by vector doubling (log2 B
    steps): ``a^(k+1+i) = a^k * a^(1+i)``.  Products of two values < 2^31
    fit u64, so plain ``%`` is exact."""
    global _minstd_pows
    if _minstd_pows is None:
        p = np.empty(_MINSTD_BLOCK, dtype=np.uint64)
        p[0] = _MINSTD_A
        k = 1
        while k < _MINSTD_BLOCK:
            j = min(k, _MINSTD_BLOCK - k)
            p[k:k + j] = (p[:j] * p[k - 1]) % _MINSTD_M
            k += j
        _minstd_pows = p
    return _minstd_pows


def _minstd_draws(x: np.uint64, n: int):
    """``n`` uniform(0,1) doubles from engine state ``x`` (vectorized jump:
    state_j = x * a^j mod m), plus the advanced state.  Bit-identical to the
    scalar generate_canonical loop — the float math is the same IEEE ops
    elementwise."""
    pows = _minstd_power_table()
    out = np.empty(n, dtype=np.float64)
    done = 0
    while done < n:
        take = min(n - done, _MINSTD_BLOCK // 2)
        states = (pows[:2 * take] * x) % _MINSTD_M
        d1 = (states[0::2] - np.uint64(1)).astype(np.float64)
        d2 = (states[1::2] - np.uint64(1)).astype(np.float64)
        out[done:done + take] = (d1 + d2 * _MINSTD_R) / (_MINSTD_R * _MINSTD_R)
        x = states[-1]
        done += take
    return out, x


def minstd0_uniform_stream(n: int, seed: int = 42) -> np.ndarray:
    """First n doubles of libstdc++ ``uniform_real_distribution<double>(0,1)``
    over ``minstd_rand0(seed)``: two engine draws per double via
    generate_canonical, sum/factor arithmetic in float64."""
    out, _ = _minstd_draws(np.uint64(seed), n)
    return out


def random_filter_values(num_keys: int, seed: int = 42) -> np.ndarray:
    """Random filter (``filter.cpp:122-147``): seeded uniform(0,1) doubles,
    cast to float32 as the reference does (``filter.cpp:142``)."""
    return minstd0_uniform_stream(num_keys, seed).astype(np.float32)


class RandomFilterStream:
    """Stateful random-filter stream for batched builds: values continue the
    same minstd_rand0(42) sequence across key batches, so batch decomposition
    does not change the assigned values (keys are processed in ascending
    order globally)."""

    def __init__(self, seed: int = 42):
        self._x = np.uint64(seed)

    def take(self, n: int) -> np.ndarray:
        out, self._x = _minstd_draws(self._x, n)
        return out.astype(np.float32)


def sort_order(filter_values: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Ascending filter value, ties broken by key (deterministic total order;
    the reference's std::sort is unstable on ties, ``db_builder.cpp:284``)."""
    return np.lexsort((keys, filter_values))
