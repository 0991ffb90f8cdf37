"""Native (C) kernels for the host/runtime-side packet path.

The reference's packet framing is tight C99 bit manipulation; the
accelerator is the wrong tool for per-byte polynomial division and index-chasing swaps,
so these inner loops are implemented natively (feckit.c), compiled once
with the system compiler, and loaded via ctypes.  Every entry point has
a pure-Python fallback so the package works without a compiler.

API: ``native.lib`` is None when unavailable; the fec modules consult
``native.crc_key`` etc. which dispatch automatically.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import tempfile

import numpy as np

_DIR = pathlib.Path(__file__).parent
_SRC = _DIR / "feckit.c"
_SRC_IO = _DIR / "iokit.c"

lib = None


def _build() -> ctypes.CDLL | None:
    so = _DIR / "_feckit.so"
    try:
        srcs = [_SRC] + ([_SRC_IO] if _SRC_IO.exists() else [])
        newest = max(f.stat().st_mtime for f in srcs)
        if not so.exists() or so.stat().st_mtime < newest:
            with tempfile.TemporaryDirectory() as td:
                tmp = pathlib.Path(td) / "_feckit.so"
                subprocess.run(
                    ["gcc", "-O2", "-shared", "-fPIC",
                     "-o", str(tmp)] + [str(f) for f in srcs],
                    check=True, capture_output=True)
                tmp.replace(so)
        L = ctypes.CDLL(str(so))
        L.ldt_crc.restype = ctypes.c_uint32
        L.ldt_crc.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.c_uint32, ctypes.c_uint32]
        L.ldt_checksum.restype = ctypes.c_uint32
        L.ldt_checksum.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        L.ldt_interleave_pass.restype = None
        L.ldt_interleave_pass.argtypes = [u8p, ctypes.c_size_t,
                                          ctypes.c_uint, ctypes.c_uint]
        L.ldt_interleave_pass_mask.restype = None
        L.ldt_interleave_pass_mask.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_uint, ctypes.c_uint,
            ctypes.c_uint8]
        L.ldt_msequence.restype = None
        L.ldt_msequence.argtypes = [ctypes.c_uint, ctypes.c_uint,
                                    ctypes.c_uint, ctypes.c_size_t, u8p]
        return L
    except Exception:
        return None


lib = _build()


def crc_key(msg: np.ndarray, rpoly: int, mask: int) -> int | None:
    """Native reflected-CRC; None if the native library is unavailable."""
    if lib is None:
        return None
    msg = np.ascontiguousarray(msg, np.uint8)
    return int(lib.ldt_crc(msg.tobytes(), len(msg), rpoly, mask))


def checksum(msg: np.ndarray) -> int | None:
    if lib is None:
        return None
    msg = np.ascontiguousarray(msg, np.uint8)
    return int(lib.ldt_checksum(msg.tobytes(), len(msg)))


def interleave_pass(x: np.ndarray, M: int, N: int,
                    mask: int | None = None) -> bool:
    """In-place permutation pass; returns False if unavailable."""
    if lib is None:
        return False
    assert x.dtype == np.uint8 and x.flags["C_CONTIGUOUS"]
    if mask is None:
        lib.ldt_interleave_pass(x, len(x), M, N)
    else:
        lib.ldt_interleave_pass_mask(x, len(x), M, N, mask)
    return True


def msequence_bits(m: int, g: int, v: int, n: int) -> np.ndarray | None:
    if lib is None:
        return None
    out = np.zeros(n, np.uint8)
    lib.ldt_msequence(m, g, v, n, out)
    return out
