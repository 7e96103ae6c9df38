"""ctypes loader for the native host-side analysis library.

The compute path is JAX/XLA on the device; the *setup-time* sparse analysis
(structure detection, block scattering) is scalar pointer-chasing work that
belongs on the host — the reference implements it in C++
(multistage_kkt.hpp:420-818) and so do we (csrc/structure.cpp).

The library is compiled on first use with the system toolchain and cached
next to the package; a pure-numpy fallback keeps everything working where
no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "..", "csrc", "structure.cpp")
_CACHED_SO = os.path.join(os.path.dirname(__file__), "_structure.so")


def _build() -> str | None:
    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        return None
    if os.path.exists(_CACHED_SO) and os.path.getmtime(_CACHED_SO) >= os.path.getmtime(src):
        return _CACHED_SO
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", _CACHED_SO],
            check=True,
            capture_output=True,
        )
        return _CACHED_SO
    except Exception:
        return None


def _lib():
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        so = _build()
        if so is not None:
            lib = ctypes.CDLL(so)
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
            I = ctypes.c_int64
            lib.piqp_tpu_detect_structure.restype = I
            lib.piqp_tpu_detect_structure.argtypes = [
                I, i64p, i64p, I, u8p, i64p, i64p,
                ctypes.POINTER(I), ctypes.POINTER(I),
            ]
            lib.piqp_tpu_scatter_P.restype = I
            lib.piqp_tpu_scatter_P.argtypes = [
                I, i64p, i64p, f64p, i64p, i64p, I, I, I, f64p, f64p, f64p, f64p,
            ]
            lib.piqp_tpu_scatter_constr.restype = I
            lib.piqp_tpu_scatter_constr.argtypes = [
                I, I, i64p, i64p, f64p, i64p, i64p, i64p, i64p,
                I, I, I, I, f64p, f64p, f64p,
            ]
            _LIB = lib
    return _LIB


def have_native() -> bool:
    return _lib() is not None


def detect_structure(indptr, indices, n, band_cap: int = 0):
    """Detect arrow columns + block-tridiagonal partition of a symmetric
    sparsity pattern.  Returns (is_arrow bool[n], starts, sizes)."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    lib = _lib()
    if lib is not None:
        is_arrow = np.zeros(n, np.uint8)
        starts = np.zeros(max(n, 1), np.int64)
        sizes = np.zeros(max(n, 1), np.int64)
        nb = ctypes.c_int64(0)
        aw = ctypes.c_int64(0)
        rc = lib.piqp_tpu_detect_structure(
            n, indptr, indices, band_cap, is_arrow, starts, sizes,
            ctypes.byref(nb), ctypes.byref(aw),
        )
        assert rc == 0
        nb = nb.value
        return is_arrow.astype(bool), starts[:nb].copy(), sizes[:nb].copy()
    return _detect_structure_np(indptr, indices, n, band_cap)


def _detect_structure_np(indptr, indices, n, band_cap=0):
    """Pure-numpy fallback (same algorithm as csrc/structure.cpp)."""
    if n == 0:
        return np.zeros(0, bool), np.zeros(0, np.int64), np.zeros(0, np.int64)
    cols = np.repeat(np.arange(n), np.diff(indptr))
    rows = indices
    off = rows != cols
    lo = np.minimum(rows, cols)[off]
    hi = np.maximum(rows, cols)[off]
    d = hi - lo
    if band_cap <= 0:
        med = int(np.median(d)) if d.size else 0
        band_cap = max(32, 4 * med)
    # greedy vertex cover of long-range edges
    long = d > band_cap
    llo, lhi = lo[long], hi[long]
    is_arrow = np.zeros(n, bool)
    covered = np.zeros(len(llo), bool)
    while not covered.all():
        cnt = np.bincount(
            np.concatenate([llo[~covered], lhi[~covered]]), minlength=n
        )
        cnt[is_arrow] = 0
        best = int(np.argmax(cnt))
        if cnt[best] == 0:
            break
        is_arrow[best] = True
        covered |= (llo == best) | (lhi == best)

    keep = ~is_arrow
    newidx = np.full(n, -1, np.int64)
    newidx[keep] = np.arange(keep.sum())
    nr = int(keep.sum())
    minc_r = np.arange(nr)
    sel = keep[lo] & keep[hi] & (lo != hi)
    np.minimum.at(minc_r, newidx[hi[sel]], newidx[lo[sel]])

    sufmin = np.empty(nr + 1, np.int64)
    sufmin[nr] = nr
    for i in range(nr - 1, -1, -1):
        sufmin[i] = min(minc_r[i], sufmin[i + 1])

    starts, sizes = [], []
    s = 0
    while s < nr:
        e = s + 1
        while e < nr and sufmin[e] < s:
            e += 1
        starts.append(s)
        sizes.append(e - s)
        s = e
    return is_arrow, np.asarray(starts, np.int64), np.asarray(sizes, np.int64)


def scatter_P(indptr, indices, values, var_stage, var_off, T, D, Da):
    """Scatter a symmetric CSC P (upper or full) into padded stage blocks."""
    n = len(indptr) - 1
    Pd = np.zeros((T, D, D))
    Psub = np.zeros((T, D, D))
    Pa = np.zeros((T, Da, D))
    Pc = np.zeros((Da, Da))
    lib = _lib()
    args = (
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int64),
        np.ascontiguousarray(values, np.float64),
        np.ascontiguousarray(var_stage, np.int64),
        np.ascontiguousarray(var_off, np.int64),
    )
    if lib is not None:
        rc = lib.piqp_tpu_scatter_P(n, *args, T, D, Da, Pd, Psub, Pa, Pc)
        if rc != 0:
            raise ValueError("P couples non-adjacent stages")
        return Pd, Psub, Pa, Pc
    return _scatter_P_np(n, *args, T=T, D=D, Da=Da, Pd=Pd, Psub=Psub, Pa=Pa, Pc=Pc)


def _scatter_P_np(n, indptr, indices, values, var_stage, var_off, T, D, Da,
                  Pd, Psub, Pa, Pc):
    for j in range(n):
        for k in range(indptr[j], indptr[j + 1]):
            i = indices[k]
            if i < j:
                continue  # full symmetric input: lower triangle + mirror
            v = values[k]
            r, c = i, j
            sr, sc = var_stage[r], var_stage[c]
            orow, ocol = var_off[r], var_off[c]
            if sr < 0 and sc < 0:
                Pc[orow, ocol] += v
                if r != c:
                    Pc[ocol, orow] += v
            elif sr < 0:
                Pa[sc, orow, ocol] += v
            elif sc < 0:
                Pa[sr, ocol, orow] += v
            elif sr == sc:
                Pd[sr, orow, ocol] += v
                if r != c:
                    Pd[sr, ocol, orow] += v
            elif sr == sc + 1:
                Psub[sc, orow, ocol] += v
            else:
                raise ValueError("P couples non-adjacent stages")
    return Pd, Psub, Pa, Pc


def scatter_constr(csr_indptr, csr_indices, csr_values, var_stage, var_off,
                   row_bucket, row_slot, T, rmax, D, Da):
    rows = len(csr_indptr) - 1
    M1 = np.zeros((T, rmax, D))
    M2 = np.zeros((T, rmax, D))
    Mg = np.zeros((T, rmax, Da))
    lib = _lib()
    args = (
        np.ascontiguousarray(csr_indptr, np.int64),
        np.ascontiguousarray(csr_indices, np.int64),
        np.ascontiguousarray(csr_values, np.float64),
        np.ascontiguousarray(var_stage, np.int64),
        np.ascontiguousarray(var_off, np.int64),
        np.ascontiguousarray(row_bucket, np.int64),
        np.ascontiguousarray(row_slot, np.int64),
    )
    if lib is not None:
        n = len(var_stage)
        rc = lib.piqp_tpu_scatter_constr(
            rows, n, *args, T, rmax, D, Da, M1, M2, Mg
        )
        if rc != 0:
            raise ValueError("constraint row spans non-adjacent stages")
        return M1, M2, Mg
    # numpy fallback
    for r in range(rows):
        bk, slot = row_bucket[r], row_slot[r]
        for k in range(csr_indptr[r], csr_indptr[r + 1]):
            c = csr_indices[k]
            v = csr_values[k]
            sc, oc = var_stage[c], var_off[c]
            if sc < 0:
                Mg[bk, slot, oc] += v
            elif sc == bk:
                M1[bk, slot, oc] += v
            elif sc == bk + 1:
                M2[bk, slot, oc] += v
            else:
                raise ValueError("constraint row spans non-adjacent stages")
    return M1, M2, Mg
