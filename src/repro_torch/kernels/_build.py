"""Build and load the port's CUDA kernels (``csrc/bfs_kernels.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, on first use, into ``build/kernels/`` at the
root of the checkout; the library's name carries a hash of the source and
flags, so an edited source rebuilds.  The library is loaded with
``ctypes``: every pointer and the stream are ``c_void_p``, sizes are
``c_longlong``.  Importing this module needs no ``nvcc`` and no card;
only a CUDA tensor reaching a kernel builds and loads the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "bfs_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    # words, dist, dist_out, new_out, words_out, batch, w, m, s, level, stream
    "bfs_fold_update": [_P] * 5 + [_N] * 4 + [_I, _P],
    # blocks, row_ptr, block_cols, x, y, n_block_rows, d, stream
    "bfs_bsr_spmm": [_P] * 5 + [_N] * 2 + [_P],
    # mask, out, w, s, stream
    "bfs_bitpack": [_P] * 2 + [_N] * 2 + [_P],
}

_build_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler (``PATH`` first, then the toolkit's
    default prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbfs_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the current library exists; returns its
    path.  The compiler's report (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept beside it as ``<name>.log``."""
    with _build_lock:
        out = library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
        return out


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.bfs_error_string.argtypes = [ctypes.c_int]
    lib.bfs_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry point ``name`` on ``device``'s current stream and
    raise if CUDA refused the launch."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.bfs_error_string(err).decode()})")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Check that a kernel's tensors share one CUDA device and are
    contiguous; return the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel operands must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev
