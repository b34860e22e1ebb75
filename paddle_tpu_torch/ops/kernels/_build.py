"""Build ``csrc/*.cu`` with ``nvcc`` and load the libraries with ctypes.

Each source becomes its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes), compiled
for ``sm_90a`` into ``paddle_tpu_torch/_build/`` the first time a kernel
is needed. A library is named by the hash of its source, the shared
headers and the flags, so an unchanged source is never rebuilt.
:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for every one of them.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0. Kernels launch on the caller's
current CUDA stream (:func:`stream_handle`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"
SOURCES = ("paged_decode", "flash_chunk", "flash_attention", "fused",
           "decode_attention", "rope")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}_{_digest(name)}.so"


def log_path(name: str) -> Path:
    """The ``nvcc`` output of the last build of ``name`` (ptxas's
    register and shared-memory report included)."""
    return BUILD / f"{name}.log"


def build(names: Iterable[str] = SOURCES) -> Dict[str, bool]:
    """Build every named library that is missing, one ``nvcc`` process
    per source, all started together. Returns ``{name: built}`` (False
    for a library reused from an earlier build); raises with the
    compiler's output when any build fails."""
    names = list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(log_path(name), "wb")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        try:
            proc = subprocess.Popen(cmd, stdout=log,
                                    stderr=subprocess.STDOUT)
        except BaseException:
            log.close()
            raise
        started[name] = (proc, log, tmp, out)
    failed = []
    for name, (proc, log, tmp, out) in started.items():
        try:
            rc = proc.wait()
        finally:
            log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append((name, rc))
    if failed:
        msgs = [f"{n}: nvcc exited {rc}\n"
                f"{log_path(n).read_text(errors='replace')[-4000:]}"
                for n, rc in failed]
        raise RuntimeError("kernel build failed\n" + "\n".join(msgs))
    return {name: name in started for name in names}


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with
    ``argtypes`` set from ``signatures`` and ``restype`` ``c_int`` for
    each entry point. Pointers and the stream must be declared
    ``c_void_p``, or ctypes would pass them as 32-bit ints."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str):
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.ptt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on
    ``device``, for the C entry points."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
