"""Build and load the port's CUDA kernels (every ``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object, all
of them at once in parallel processes, and the objects are linked into
one shared library with a plain C interface, on first use, into
``build/kernels/`` at the root of the checkout; the library's name
carries a hash of every source, every header (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds.  The library is loaded with ``ctypes``: every pointer and the
stream are ``c_void_p``, sizes are ``c_longlong``.  Importing this module
needs no ``nvcc`` and no card; only a CUDA tensor reaching a kernel
builds and loads the library.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _N, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # words, dist, dist_out, new_out, words_out, batch, w, m, s, level, stream
    "bfs_fold_update": [_P] * 5 + [_N] * 4 + [_I, _P],
    # blocks, row_ptr, block_cols, work, x, y, least, k, n_items, n_dt, d,
    # stream
    "bfs_bsr_spmm": [_P] * 7 + [_N] * 4 + [_P],
    # mask, out, w, s, stream
    "bfs_bitpack": [_P] * 2 + [_N] * 2 + [_P],
    # bits, col_mask, block_rows, block_cols, fwords, out, front_any,
    # tiles_read (or null), k, n_fwords, group_block_rows, n_valid,
    # n_blocks, seg, w, s, stream
    "bfs_bsr_expand_bits": [_P] * 8 + [_N] * 8 + [_P],
    # frontier, row_ptr, dst, fmask, table, chunk_rows, out, edges_read (or
    # null), g, shard, n, n_blocks, n_edges, chunk, s, stream
    "bfs_expand_dense": [_P] * 8 + [_N] * 7 + [_P],
    # q, k_hi, k_lo, vt, vt_lo, o, b, hq, hkv, sq, skv, skv_pad, dh, causal,
    # window, scale, stream (k_hi, k_lo, vt, vt_lo: the pre-pass's scratch)
    "attn_flash_fwd_f32": [_P] * 6 + [_N] * 7 + [_I, _N, _F, _P],
    # k, v, k_hi, k_lo, vt, vt_lo, b * hkv, skv, skv_pad, dh, stream
    "attn_split_kv_f32": [_P] * 6 + [_N] * 4 + [_P],
    # q, k, v, o, b, hq, hkv, sq, skv, dh, causal, window, scale, stream
    "attn_flash_fwd_bf16": [_P] * 4 + [_N] * 6 + [_I, _N, _F, _P],
    # idx, table, out, b, l, d, bf16, granule, stages, bags, slots, chunks,
    # idx_words, row_stage_bytes, smem, grid, stream
    "emb_bag_gather": [_P] * 3 + [_N] * 3 + [_I] + [_N] * 9 + [_P],
    # idx, table, out, b, l, d, bf16, stream
    "emb_bag_sum": [_P] * 3 + [_N] * 3 + [_I, _P],
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


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha1(repr(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):         # the sources and headers
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"libkernels-{digest.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the kernels unless the current library exists; returns its
    path.  The compiler's report (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept beside it as ``<name>.log``."""
    with _build_lock:
        out = library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        objs, procs = [], []
        for src in sources():
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, proc in procs:              # wait for every compiler
            text, _ = proc.communicate()
            logs.append(text)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_name(f"{tag}.so.tmp")
        logs.append(_run([nvcc(), "-gencode", NVCC_FLAGS[1], "-shared",
                          "-o", str(tmp), *map(str, objs)]))
        for obj in objs:
            obj.unlink()
        out.with_suffix(".log").write_text("".join(logs))
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
    lib.bfs_expand_bits_smem.argtypes = []
    lib.bfs_expand_bits_smem.restype = ctypes.c_int
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
