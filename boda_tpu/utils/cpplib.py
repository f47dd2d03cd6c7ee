"""Loader + typed wrappers for the native C++ core library (csrc/ →
build/libboda_tpu_core.so).

The native library provides the performance-critical host paths mirroring
the reference's C++ layers: the lexp parser (csrc/lexp.cc), the nda digest
kernel (csrc/nda_digest.cc), the framed stream transport (csrc/stream.cc),
and bottom-left-fill bin packing (csrc/blf_pack.cc). Python falls back to
the pure implementations when the library isn't built; differential tests
(tests/test_cpp_core.py) pin both paths to identical behavior.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np

_LIB_NAMES = ("libboda_tpu_core.so",)


def _build(root: Path) -> None:
    """`make -C csrc` (tracked sources -> build/), once per checkout: a file
    lock keeps concurrent first users (test workers) from racing."""
    import fcntl
    import shutil
    import subprocess
    if shutil.which("make") is None:
        return
    (root / "build").mkdir(exist_ok=True)
    with open(root / "build" / ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if (root / "build" / _LIB_NAMES[0]).exists():
            return
        try:
            subprocess.run(["make", "-C", str(root / "csrc")], check=True,
                           capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            pass  # no compiler: the pure-Python paths serve


@lru_cache(maxsize=1)
def load_cpp() -> Optional[ctypes.CDLL]:
    """The native library, built from csrc/ at first use; None when it
    cannot be built or loaded."""
    root = Path(__file__).resolve().parents[2]
    # explicit override (used by scripts/ci_sanitize.sh to load the
    # ASan/UBSan-instrumented build)
    override = os.environ.get("BODA_TPU_CORE_LIB")
    if override:
        lib = ctypes.CDLL(override)  # let a bad override fail loudly
        _declare(lib)
        return lib
    p = root / "build" / _LIB_NAMES[0]
    if not p.exists():
        _build(root)
    if not p.exists():
        return None
    try:
        lib = ctypes.CDLL(str(p))
    except OSError:
        return None
    _declare(lib)
    return lib


def cpp_available() -> bool:
    return load_cpp() is not None


def _declare(lib: ctypes.CDLL) -> None:
    lib.boda_lexp_parse.argtypes = [ctypes.c_char_p]
    lib.boda_lexp_parse.restype = ctypes.c_void_p
    lib.boda_lexp_err.argtypes = [ctypes.c_void_p]
    lib.boda_lexp_err.restype = ctypes.c_char_p
    lib.boda_lexp_n_nodes.argtypes = [ctypes.c_void_p]
    lib.boda_lexp_n_nodes.restype = ctypes.c_int32
    lib.boda_lexp_node.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p)]
    lib.boda_lexp_free.argtypes = [ctypes.c_void_p]

    lib.boda_nda_digest.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_char_p]
    lib.boda_nda_digest.restype = ctypes.c_int

    lib.boda_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_int]
    lib.boda_stream_open.restype = ctypes.c_int
    lib.boda_stream_write_frame.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                            ctypes.c_int64]
    lib.boda_stream_write_frame.restype = ctypes.c_int
    lib.boda_stream_read_frame.argtypes = [ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_void_p)]
    lib.boda_stream_read_frame.restype = ctypes.c_int64
    lib.boda_stream_buf_free.argtypes = [ctypes.c_void_p]
    lib.boda_stream_close.argtypes = [ctypes.c_int]
    lib.boda_stream_close.restype = ctypes.c_int

    lib.boda_blf_place.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.boda_blf_place.restype = ctypes.c_int32


# ---- lexp ----

def cpp_parse_lexp_flat(s: str):
    """Parse via the native parser. Returns a list of
    (parent_ix, is_leaf, name, val) in pre-order, or raises the same
    RtErr text the Python parser would."""
    from ..core.error import RtErr
    lib = load_cpp()
    h = lib.boda_lexp_parse(s.encode())
    try:
        err = lib.boda_lexp_err(h)
        if err is not None:
            raise RtErr(err.decode())
        n = lib.boda_lexp_n_nodes(h)
        par = ctypes.c_int32()
        leaf = ctypes.c_int32()
        name = ctypes.c_char_p()
        val = ctypes.c_char_p()
        out = []
        for i in range(n):
            lib.boda_lexp_node(h, i, ctypes.byref(par), ctypes.byref(leaf),
                               ctypes.byref(name), ctypes.byref(val))
            out.append((par.value, bool(leaf.value), name.value.decode(),
                        val.value.decode()))
        return out
    finally:
        lib.boda_lexp_free(h)


# ---- nda digest ----

def cpp_nda_digest_stats(fv: np.ndarray) -> tuple[float, float, float, float, str]:
    """(vmin, vmax, avg, rms, qhash16) over a contiguous float64 array."""
    lib = load_cpp()
    fv = np.ascontiguousarray(fv, dtype=np.float64).reshape(-1)
    stats = (ctypes.c_double * 4)()
    qhash = ctypes.create_string_buffer(17)
    rc = lib.boda_nda_digest(
        fv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), fv.size, stats, qhash)
    if rc != 0:
        raise RuntimeError(f"boda_nda_digest failed rc={rc}")
    return stats[0], stats[1], stats[2], stats[3], qhash.value.decode()


# ---- stream ----

class CppStream:
    """Framed stream over the native transport (same wire format as
    parallel/transport.py Stream)."""

    def __init__(self, addr: str, is_server: bool = False):
        from ..core.error import RtErr
        self._lib = load_cpp()
        err = ctypes.create_string_buffer(512)
        self.h = self._lib.boda_stream_open(addr.encode(), int(is_server), err, 512)
        if self.h < 0:
            raise RtErr(err.value.decode())

    def write_frame(self, payload: bytes) -> None:
        if self._lib.boda_stream_write_frame(self.h, payload, len(payload)) != 0:
            from ..core.error import RtErr
            raise RtErr("cpp stream: write failed")

    def read_frame(self) -> bytes:
        out = ctypes.c_void_p()
        n = self._lib.boda_stream_read_frame(self.h, ctypes.byref(out))
        if n < 0:
            from ..core.error import RtErr
            raise RtErr("stream: EOF while reading")
        try:
            return ctypes.string_at(out, n)
        finally:
            self._lib.boda_stream_buf_free(out)

    def close(self) -> None:
        self._lib.boda_stream_close(self.h)


# ---- blf packing ----

def cpp_blf_place(sizes, bin_sz, pad):
    """sizes: list of (y,x); returns (n_bins, [(bin_ix, y0, x0), ...]) or
    raises on an oversized rect (mirrors blf_place's RtErr)."""
    from ..core.error import RtErr
    lib = load_cpp()
    n = len(sizes)
    arr = (ctypes.c_int64 * (2 * n))()
    for i, (y, x) in enumerate(sizes):
        arr[2 * i] = int(y)
        arr[2 * i + 1] = int(x)
    out = (ctypes.c_int64 * (3 * n))()
    nb = lib.boda_blf_place(arr, n, int(bin_sz[0]), int(bin_sz[1]),
                            int(pad[0]), int(pad[1]), out)
    if nb < 0:
        raise RtErr(f"blf_place: rect larger than bin {bin_sz}")
    return nb, [(out[3 * i], out[3 * i + 1], out[3 * i + 2]) for i in range(n)]
