"""ctypes loader for the native golden NTT, gpufhe_tpu_torch/csrc/golden_ntt.c
(counterpart of gpufhe_tpu/golden/native.py).

The library is compiled on first use with `cc -O2 -shared -fPIC` into
gpufhe_tpu_torch/csrc/build/. Its name carries a hash of the source, and it
is written under a temporary name and renamed into place, so a stale or
half-written library is never loaded, and processes that build it at once
do not collide. Where no C compiler is found, get_lib() returns None and
golden/ntt.py runs its numpy path; the outputs are the same either way
(exact integer arithmetic). `get_lib() is not None` says which path the
golden NTT takes for a prime below 2^62.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
_SOURCE = _CSRC / "golden_ntt.c"
_lib = None
_tried = False


def lib_path() -> pathlib.Path:
    digest = hashlib.sha1(_SOURCE.read_bytes()).hexdigest()[:12]
    return _CSRC / "build" / f"libgolden_ntt-{digest}.so"


def get_lib():
    """The loaded library, built on first use; None without a C compiler."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = lib_path()
    if not path.exists():
        cc = shutil.which("cc") or shutil.which("gcc")
        if cc is None:
            return None
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SOURCE)],
                           check=True, capture_output=True)
            os.replace(tmp, path)
        except (OSError, subprocess.CalledProcessError):
            return None
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(path))
    for name in ("ntt_fwd_u64", "ntt_inv_u64"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_uint64, ctypes.c_uint64]
    _lib = lib
    return _lib


def ntt_u64(x, q: int, psi: int, inverse: bool):
    """The transform of uint64[..., n] along its last axis (on a copy), or
    None when the native library is unavailable or q >= 2^62."""
    lib = get_lib()
    if lib is None or q >= (1 << 62):
        return None
    arr = np.asarray(x, dtype=np.uint64)
    shape, n = arr.shape, arr.shape[-1]
    flat = np.array(arr.reshape(-1, n), dtype=np.uint64, order="C")  # a copy
    fn = lib.ntt_inv_u64 if inverse else lib.ntt_fwd_u64
    fn(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), flat.shape[0], n, q, psi)
    return flat.reshape(shape)
