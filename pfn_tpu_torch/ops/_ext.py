"""Build, load and launch the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` into a shared library
with a plain C interface and bound with ``ctypes``: no PyTorch headers, so a
build takes seconds. The library is built on first use into
``build/pfn_tpu_torch/`` at the root of the checkout, under a name that
carries the hash of its source and flags, so an edited source is rebuilt and
an unchanged one is reused. Nothing is built or loaded when this module is
imported.

Every launch goes through a wrapper here that checks device, dtype, shape,
contiguity and alignment, allocates the outputs with ``torch.empty``, launches
on the current stream, raises if the launch reports an error, and adds one to
``launch_counts``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pfn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)
SOURCE = Path(__file__).resolve().parent / "csrc" / "pfn_flash_fwd.cu"
FLASH_FWD_HEAD_DIMS = (32, 64, 128)

# Kernel launches since the last reset_launch_counts(), by kernel name.
launch_counts = {"pfn_flash_fwd": 0}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{SOURCE.stem}-{digest}.so"


def build() -> dict:
    """Compile the kernel source unless a library for its current hash exists.

    Returns {"path", "seconds", "built", "log"}; ``log`` holds ptxas's
    per-kernel register and shared-memory report. Raises if nvcc fails.
    """
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "built": True, "log": proc.stdout + proc.stderr}


def _library() -> ctypes.CDLL:
    """Build if needed and load the library, once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        lib.pfn_flash_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.pfn_flash_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sep: torch.Tensor,
              include_diag: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the PFN flash-attention forward kernel.

    q: (BH, Tq, D), k and v: (BH, Tk, D), all contiguous CUDA tensors of one
    dtype (float32 or bfloat16), q already scaled. ``sep``: a one-element
    int32 tensor on the same device. Returns (o (BH, Tq, D) in q's dtype,
    lse (BH, Tq) float32).
    """
    if not (q.is_cuda and k.device == q.device and v.device == q.device and sep.device == q.device):
        raise ValueError("pfn_flash_fwd: q, k, v and sep must lie on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"pfn_flash_fwd: dtypes {q.dtype}, {k.dtype}, {v.dtype}; need all float32 or all bfloat16")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"pfn_flash_fwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    if D not in FLASH_FWD_HEAD_DIMS:
        raise ValueError(f"pfn_flash_fwd: head dim {D} not in {FLASH_FWD_HEAD_DIMS}")
    if include_diag and Tq != Tk:
        raise ValueError(f"pfn_flash_fwd: the diagonal variant needs Tq == Tk, got {Tq} and {Tk}")
    if BH > 65535:
        raise ValueError(f"pfn_flash_fwd: B*H = {BH} exceeds the grid's y limit 65535")
    if sep.dtype != torch.int32 or sep.numel() != 1:
        raise ValueError("pfn_flash_fwd: sep must be a one-element int32 tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"pfn_flash_fwd: {name} must be contiguous and 16-byte aligned")
    o = torch.empty_like(q)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=q.device)
    if BH == 0 or Tq == 0:
        return o, lse
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.pfn_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), sep.data_ptr(),
            BH, Tq, Tk, D, int(q.dtype == torch.bfloat16), int(include_diag),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pfn_flash_fwd: launch failed with CUDA error {err}")
    launch_counts["pfn_flash_fwd"] += 1
    return o, lse
