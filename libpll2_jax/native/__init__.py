"""Native (C++) data layer bindings.

The host-side pipeline that feeds the device — FASTA scanning, site-pattern
compression, tip encoding — is implemented in C++ (native/msa_native.cpp),
exposed over a C ABI and bound with ctypes (no pybind11 in this image).
Everything here has a pure-numpy fallback in io/; the native path is
selected automatically when the shared library is available (build with
`ensure_native()`, cached under native/build/).

Set LIBPLL2_NATIVE=0 to force the numpy paths.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO / "native" / "msa_native.cpp"
_LIB = _REPO / "native" / "build" / "libmsa_native.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def ensure_native(force: bool = False) -> bool:
    """Build (once) and load the native library. Returns availability."""
    global _lib, _tried
    if _lib is not None:
        return True
    if _tried and not force:
        return False
    _tried = True
    if os.environ.get("LIBPLL2_NATIVE") == "0":
        return False
    try:
        if not _LIB.exists() or (_SRC.exists()
                                 and _SRC.stat().st_mtime
                                 > _LIB.stat().st_mtime):
            _LIB.parent.mkdir(parents=True, exist_ok=True)
            # build beside the target and rename: concurrent processes
            # (test workers) never load a half-written library
            tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-std=c++17", str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(str(_LIB))
    except (OSError, subprocess.SubprocessError):
        return False

    lib.pllt_compress_patterns.restype = ctypes.c_int64
    lib.pllt_compress_patterns.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.pllt_encode_tip.restype = ctypes.c_int64
    lib.pllt_encode_tip.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.pllt_fasta_scan.restype = ctypes.c_int64
    lib.pllt_fasta_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.pllt_fasta_read.restype = ctypes.c_int64
    lib.pllt_fasta_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return True


def available() -> bool:
    return ensure_native()


def compress_patterns(enc: np.ndarray):
    """Native column compression. enc: [count, length] uint8 (0 = illegal).

    Returns (site_pattern_map, weights, rep_sites) with patterns in
    ascending lexicographic order (np.unique-compatible)."""
    if not ensure_native():
        raise RuntimeError("native library unavailable")
    enc = np.ascontiguousarray(enc, dtype=np.uint8)
    count, length = enc.shape
    site_map = np.empty(length, dtype=np.uint32)
    weights = np.empty(length, dtype=np.uint32)
    reps = np.empty(length, dtype=np.uint32)
    n = _lib.pllt_compress_patterns(
        enc.ctypes.data, count, length, site_map.ctypes.data,
        weights.ctypes.data, reps.ctypes.data)
    if n < 0:
        raise ValueError("native compression failed")
    return site_map, weights[:n], reps[:n]


def encode_tip(seq: bytes, map_arr: np.ndarray) -> np.ndarray:
    """Native chars -> uint64 state bit-masks; raises on illegal chars."""
    if not ensure_native():
        raise RuntimeError("native library unavailable")
    raw = np.frombuffer(seq, dtype=np.uint8)
    m = np.ascontiguousarray(map_arr, dtype=np.uint64)
    out = np.empty(raw.size, dtype=np.uint64)
    bad = _lib.pllt_encode_tip(raw.ctypes.data, raw.size, m.ctypes.data,
                               out.ctypes.data)
    if bad >= 0:
        raise ValueError(
            f"illegal state character {chr(raw[bad])!r} at site {bad}")
    return out


def fasta_load(path: str):
    """Native whole-file FASTA load. Returns (labels, sequences)."""
    if not ensure_native():
        raise RuntimeError("native library unavailable")
    data = Path(path).read_bytes()
    n_rec = ctypes.c_int64()
    lab_bytes = ctypes.c_int64()
    seq_bytes = ctypes.c_int64()
    err_line = ctypes.c_int64()
    rc = _lib.pllt_fasta_scan(data, len(data), ctypes.byref(n_rec),
                              ctypes.byref(lab_bytes),
                              ctypes.byref(seq_bytes),
                              ctypes.byref(err_line))
    if rc != 0:
        raise ValueError(f"illegal FASTA character on line {err_line.value}")
    n = n_rec.value
    labels_buf = ctypes.create_string_buffer(max(1, lab_bytes.value))
    seqs_buf = ctypes.create_string_buffer(max(1, seq_bytes.value))
    lab_off = np.empty(n + 1, dtype=np.int64)
    seq_off = np.empty(n + 1, dtype=np.int64)
    _lib.pllt_fasta_read(data, len(data), labels_buf,
                         lab_off.ctypes.data, seqs_buf,
                         seq_off.ctypes.data)
    lraw = labels_buf.raw
    sraw = seqs_buf.raw
    labels = [lraw[lab_off[i]:lab_off[i + 1]].decode("ascii")
              for i in range(n)]
    seqs = [sraw[seq_off[i]:seq_off[i + 1]].decode("ascii")
            for i in range(n)]
    return labels, seqs
