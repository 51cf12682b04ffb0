"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each library in LIBS is one source of gpufhe_tpu_torch/csrc/ compiled, on
first use, into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v [-D...] -o csrc/build/lib<name>-<hash>.so <source>.cu

A library may add preprocessor switches to its source: the K1 ablation
variants (ops/probes.py) are csrc/ntt.cu built with -DNTT_ABLATE=<k>, so the
production kernel's code is the same source with no switch. The library's
name carries a hash of the source, the shared headers (csrc/*.cuh) and the
flags, so a stale library is never loaded, and it is written under a
temporary name and renamed into place, so an interrupted build leaves
nothing that a later run would wait on or trust. Nothing here includes
PyTorch's headers: a build takes seconds. `build_all` starts one nvcc per
library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
# library name -> (source in csrc/, extra nvcc flags)
LIBS = {
    "ntt": ("ntt", ()),
    "convert": ("convert", ()),
    "mac": ("mac", ()),
    "rescale": ("rescale", ()),
    "tensor": ("tensor", ()),
    "int_rate": ("int_rate", ()),
    **{f"ntt_{variant}": ("ntt", (f"-DNTT_ABLATE={k}",))
       for k, variant in enumerate(("no_modmul", "no_twiddle", "copy_only", "natural_store",
                                    "narrow_tfast"), 1)},
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def lib_path(name: str) -> pathlib.Path:
    source, flags = LIBS[name]
    h = hashlib.sha1((CSRC / f"{source}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one library; returns (final path, temp path, process)."""
    source, flags = LIBS[name]
    out = lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / f"{source}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build_all(names=tuple(LIBS)) -> dict[str, str]:
    """Compile every named library that has no current build, in parallel.

    Returns nvcc's output per library built (the -Xptxas -v register and
    shared-memory summary); raises with that output if a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {n: _start(n) for n in names if not lib_path(n).exists()}
    logs = {}
    try:
        for name, (out, tmp, proc) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} ({LIBS[name][0]}.cu):\n{log}")
            os.replace(tmp, out)
            logs[name] = log
    finally:
        for _out, tmp, proc in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return logs


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    `launches` is a plain counter: `launch` adds one each time the entry
    point returned success, and nothing else touches it but `reset`.
    """

    def __init__(self, lib: str, symbol: str, argtypes):
        self.lib = lib
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._strerror = None

    def _bind(self):
        if self._fn is None:
            if not lib_path(self.lib).exists():
                build_all((self.lib,))
            lib = ctypes.CDLL(str(lib_path(self.lib)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{LIBS[self.lib][0]}_strerror")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._strerror = fn, err
        return self._fn

    def launch(self, *args) -> None:
        code = self._bind()(*args)
        if code != 0:
            msg = self._strerror(code).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {code} ({msg})")
        self.launches += 1

    def reset(self) -> None:
        self.launches = 0
