"""Build, load and launch the port's CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` into a shared library
of its own with a plain C interface and bound with ``ctypes``: no PyTorch
headers, so a build takes seconds. The libraries are built on first use into
``build/pfn_tpu_torch/`` at the root of the checkout, under names that carry
the hash of their source and flags, so an edited source is rebuilt and an
unchanged one is reused. :func:`build` compiles every missing library at
once, one ``nvcc`` process per source. Nothing is built or loaded when this
module is imported.

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
_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "pfn_flash_fwd": _CSRC / "pfn_flash_fwd.cu",
    "pfn_flash_bwd": _CSRC / "pfn_flash_bwd.cu",
    "pfn_fused_layer_fwd": _CSRC / "pfn_fused_layer_fwd.cu",
    "pfn_fused_layer_bwd": _CSRC / "pfn_fused_layer_bwd.cu",
}
# Headers the sources include; each library's hash covers them too.
HEADERS = (_CSRC / "pfn_fused_common.cuh", _CSRC / "pfn_flash_sm90.cuh", _CSRC / "pfn_flash_f32.cuh",
           _CSRC / "pfn_gemm_sm90.cuh", _CSRC / "pfn_fused_layer.cuh")
# Head dims the forward and both backward kernels are instantiated for.
FLASH_HEAD_DIMS = (32, 64, 128)
# Head dims the fused layer's attention is instantiated for, and its longest
# sequence (an f32 block holds a (32, T) f32 score row buffer).
FUSED_HEAD_DIMS = (16, 32, 64, 128)
FUSED_MAX_SEQ = 512
# The fused layer's parameters, in the order of its C entry point (the JAX
# package's ``_PARAM_ORDER``); the four matrices are in the compute dtype.
FUSED_PARAM_ORDER = (
    "wqkv", "bqkv", "wout", "bout", "ln1_g", "ln1_b",
    "w1", "b1", "w2", "b2", "ln2_g", "ln2_b",
)
FUSED_MATRICES = ("wqkv", "wout", "w1", "w2")


def fused_param_shapes(D: int, F: int) -> dict:
    """{name: shape} of the fused layer's parameters at width D and FFN
    width F, in ``FUSED_PARAM_ORDER``."""
    return {"wqkv": (D, 3 * D), "bqkv": (3 * D,), "wout": (D, D), "bout": (D,), "ln1_g": (D,), "ln1_b": (D,),
            "w1": (D, F), "b1": (F,), "w2": (F, D), "b2": (D,), "ln2_g": (D,), "ln2_b": (D,)}

# Kernel launches since the last reset_launch_counts(), by kernel name.
launch_counts = {"pfn_flash_fwd": 0, "pfn_flash_bwd_dq": 0, "pfn_flash_bwd_dkv": 0, "pfn_fused_layer_fwd": 0,
                 "pfn_fused_layer_bwd_ffn": 0, "pfn_fused_layer_bwd_attn": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each entry point: pointers, then int sizes and flags, then the stream.
_SIGNATURES = {
    "pfn_flash_fwd": ("pfn_flash_fwd", [_P] * 6 + [_I] * 6 + [_P]),
    "pfn_flash_bwd_dq": ("pfn_flash_bwd", [_P] * 8 + [_I] * 6 + [_P]),
    "pfn_flash_bwd_dkv": ("pfn_flash_bwd", [_P] * 9 + [_I] * 6 + [_P]),
    "pfn_fused_layer_fwd": ("pfn_fused_layer_fwd", [_P] * 21 + [_I] * 6 + [_P]),
    "pfn_fused_layer_bwd_ffn": ("pfn_fused_layer_bwd", [_P] * 24 + [_I] * 7 + [_P]),
    "pfn_fused_layer_bwd_attn": ("pfn_fused_layer_bwd", [_P] * 29 + [_I] * 7 + [_P]),
}

_libs: dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> Path:
    source = SOURCES[name]
    text = source.read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(names=None) -> dict:
    """Compile the sources ``names`` (default: all) whose library for the
    current hash is missing, one nvcc process each, all started together.

    Returns {name: {"path", "seconds", "built", "log"}}; ``log`` holds
    ptxas's per-kernel register and shared-memory report. Raises if any nvcc
    fails.
    """
    names = list(SOURCES) if names is None else list(names)
    results, running = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, cmd, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, cmd, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = {"path": str(out), "seconds": seconds, "built": True, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def _entry(name: str):
    """The C entry point ``name``, building and loading its library once per
    process."""
    source, argtypes = _SIGNATURES[name]
    if source not in _libs:
        _libs[source] = ctypes.CDLL(build([source])[source]["path"])
    fn = getattr(_libs[source], name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_flash_inputs(name: str, q, k, v, sep, include_diag: bool, extra=()) -> None:
    """The checks every flash kernel needs: q (BH, Tq, D), k and v (BH, Tk,
    D) and the tensors in ``extra`` (name, tensor) of q's shape, one dtype,
    one CUDA device, contiguous and 16-byte aligned; sep a one-element int32
    tensor on that device."""
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, sep, *(t for _, t in extra)))):
        raise ValueError(f"{name}: every input must lie on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in (k, v)):
        raise ValueError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; need all float32 or all bfloat16")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    for tname, t in extra:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: {tname} {tuple(t.shape)} {t.dtype} must match q {tuple(q.shape)} {q.dtype}")
    BH, Tq, D = q.shape
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {FLASH_HEAD_DIMS}")
    if include_diag and Tq != k.shape[1]:
        raise ValueError(f"{name}: the diagonal variant needs Tq == Tk, got {Tq} and {k.shape[1]}")
    if BH > 65535:
        raise ValueError(f"{name}: B*H = {BH} exceeds the grid's y limit 65535")
    if sep.dtype != torch.int32 or sep.numel() != 1:
        raise ValueError(f"{name}: sep must be a one-element int32 tensor")
    for tname, t in (("q", q), ("k", k), ("v", v), *extra):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and 16-byte aligned")


def _check_rows(name: str, q, **rows) -> None:
    """Per-row f32 inputs (lse, delta): contiguous (BH, Tq) on q's device."""
    for rname, t in rows.items():
        if t.shape != q.shape[:2] or t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {rname} must be a contiguous float32 {tuple(q.shape[:2])} tensor on q's device")


def _launch(name: str, q, *args) -> None:
    """Launch entry point ``name`` on q's device and current stream."""
    fn = _entry(name)
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    launch_counts[name] += 1


def _flags(q, k, include_diag: bool) -> tuple:
    BH, Tq, D = q.shape
    return BH, Tq, k.shape[1], D, int(q.dtype == torch.bfloat16), int(include_diag)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sep: torch.Tensor,
              include_diag: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the PFN flash-attention forward kernel.

    q: (BH, Tq, D), k and v: (BH, Tk, D), all contiguous CUDA tensors of one
    dtype (float32 or bfloat16), q already scaled. ``sep``: a one-element
    int32 tensor on the same device. Returns (o (BH, Tq, D) in q's dtype,
    lse (BH, Tq) float32).
    """
    _check_flash_inputs("pfn_flash_fwd", q, k, v, sep, include_diag)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    _launch("pfn_flash_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            sep.data_ptr(), *_flags(q, k, include_diag))
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, sep, include_diag: bool) -> torch.Tensor:
    """Launch the dq kernel of the PFN flash-attention backward.

    q and do: (BH, Tq, D); k, v: (BH, Tk, D); one dtype, contiguous, on one
    CUDA device, q scaled as in the forward. lse (from the forward) and delta
    = rowsum(do * o) [- dlse]: (BH, Tq) float32. Returns dq (BH, Tq, D) in
    q's dtype, the gradient with respect to the scaled q.
    """
    _check_flash_inputs("pfn_flash_bwd_dq", q, k, v, sep, include_diag, extra=(("do", do),))
    _check_rows("pfn_flash_bwd_dq", q, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    _launch("pfn_flash_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), sep.data_ptr(), *_flags(q, k, include_diag))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, sep, include_diag: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel of the PFN flash-attention backward; inputs as
    :func:`flash_bwd_dq`. Returns (dk, dv), (BH, Tk, D) in k's dtype."""
    _check_flash_inputs("pfn_flash_bwd_dkv", q, k, v, sep, include_diag, extra=(("do", do),))
    _check_rows("pfn_flash_bwd_dkv", q, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.numel() == 0:
        return dk, dv
    _launch("pfn_flash_bwd_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), sep.data_ptr(), *_flags(q, k, include_diag))
    return dk, dv


def fused_shape_error(D: int, H: int | None, F: int, T: int | None = None) -> str | None:
    """Why the fused layer kernels do not take widths (D, H, F) and sequence
    length T, or None if they do (H None: no head count, as the FFN
    backward, which has no attention)."""
    if H is not None and D % H:
        return f"emsize {D} % nhead {H} != 0"
    if H is not None and D // H not in FUSED_HEAD_DIMS:
        return f"head dim {D // H} not in {FUSED_HEAD_DIMS}"
    if D % 16 or F % 16:
        return f"emsize {D} and nhid {F} must be multiples of 16"
    if T is not None and T > FUSED_MAX_SEQ:
        return f"sequence length {T} > {FUSED_MAX_SEQ}"
    return None


# Rows per partial sum of the backward's column sums (bias and LayerNorm
# gradients), as in csrc/pfn_fused_layer_bwd.cu.
COLSUM_ROWS = 32


# Output tile (square) of the backward's GEMMs in both dtypes: the bf16 one
# of csrc/pfn_gemm_sm90.cuh (one block an SM) and the f32 one of
# csrc/pfn_fused_common.cuh (F32_GEMM_BLOCKS_PER_SM blocks an SM, its launch
# bounds).
WGRAD_TILE = 128
F32_GEMM_BLOCKS_PER_SM = 2


def weight_grad_splits(M: int, Kin: int, N: int, slots: int) -> int:
    """Chunks the backward cuts the M = B*T rows of the weight gradient dW
    (Kin, N) into (split-K, summed in order): as many as keep its 128 x 128
    output tiles times the chunks within one wave of ``slots`` blocks (the
    SMs times the blocks an SM holds), with at least 256 rows a chunk, at
    most 16, and at least 1."""
    tiles = -(-Kin // WGRAD_TILE) * -(-N // WGRAD_TILE)
    return max(1, min(slots // tiles, M // 256, 16))


def _weight_grad_splits(M: int, pairs, device, bf16: bool) -> tuple:
    """:func:`weight_grad_splits` of each (Kin, N) in ``pairs`` for the GEMM
    of the compute dtype."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    slots = sms if bf16 else sms * F32_GEMM_BLOCKS_PER_SM
    return tuple(weight_grad_splits(M, Kin, N, slots) for Kin, N in pairs)


def _check_fused_layer(name: str, x, params: dict, nhead: int | None, tensors=(), backward: bool = False) -> tuple:
    """The checks every fused-layer entry point needs: x a float32 (B, T, D)
    CUDA tensor; ``params`` in ``FUSED_PARAM_ORDER`` with the JAX layout, the
    four matrices in the compute dtype (float32 or bfloat16) and the vectors
    float32; every tensor in ``tensors`` (name, tensor, dtype, shape) as
    given; all on x's device, contiguous and 16-byte aligned; B and T within
    the forward's, or with ``backward`` the backward's, index and grid
    limits. Returns (B, T, D, F, compute dtype)."""
    ordered = [params[k] for k in FUSED_PARAM_ORDER]
    if not (x.is_cuda and all(t.device == x.device for t in (*ordered, *(t for _, t, _, _ in tensors)))):
        raise ValueError(f"{name}: every input must lie on one CUDA device")
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"{name}: x must be a float32 (B, T, D) tensor, got {x.dtype} {tuple(x.shape)}")
    B, T, D = x.shape
    F = params["w1"].shape[-1]
    reason = fused_shape_error(D, nhead, F, T)
    if reason is not None:
        raise ValueError(f"{name}: {reason}")
    cdt = params["wqkv"].dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {cdt}; need float32 or bfloat16")
    for k, shape in fused_param_shapes(D, F).items():
        want = cdt if k in FUSED_MATRICES else torch.float32
        t = params[k]
        if tuple(t.shape) != shape or t.dtype != want:
            raise ValueError(f"{name}: {k} is {t.dtype} {tuple(t.shape)}, need {want} {shape}")
    for tname, t, dtype, shape in tensors:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} is {t.dtype} {tuple(t.shape)}, need {dtype} {shape}")
    # int sizes in the kernels, and grid limits: B items on the attention's z
    # axis, B*T rows in 128-row GEMM tiles on y; the backward's B*T rows in
    # 64-row column-sum chunks on y, (B*H*T, T16) attention scratch and B*H
    # attention batches on the z axis of its GEMMs.
    too_large = B * T * 3 * D >= 2**31 or B > 65535 or B * T > 65535 * 128
    if backward:
        H = nhead or 1
        too_large |= B * T > 65535 * COLSUM_ROWS or B * H * T * (T + 16) >= 2**31 or B * H > 65535
    if too_large:
        raise ValueError(f"{name}: B {B} x T {T} is too large for the kernel's indexing and grid")
    for tname, t in (("x", x), *zip(FUSED_PARAM_ORDER, ordered), *((n, t) for n, t, _, _ in tensors)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and 16-byte aligned")
    return B, T, D, F, cdt


def _check_sep(name: str, sep, device) -> None:
    if sep.device != device or sep.dtype != torch.int32 or sep.numel() != 1:
        raise ValueError(f"{name}: sep must be a one-element int32 tensor on the inputs' device")


def fused_layer_fwd(x: torch.Tensor, params: dict, sep: torch.Tensor,
                    nhead: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fused encoder-layer forward: one call, which enqueues the
    layer's device kernels (eight in bf16, seven in f32) on the current
    stream and counts one launch. Its scratch is one workspace allocation.

    x: (B, T, D) float32; ``params`` holds the entries of
    ``FUSED_PARAM_ORDER`` in the JAX package's layout: the four matrices
    (wqkv (D, 3D), wout (D, D), w1 (D, F), w2 (F, D)) all float32 or all
    bfloat16, which is the compute dtype, and the eight vectors float32; all
    contiguous on x's CUDA device. ``sep``: a one-element int32 tensor there.
    Returns (y, r (B, T, D), lse (B, T, H)), all float32.
    """
    name = "pfn_fused_layer_fwd"
    B, T, D, F, cdt = _check_fused_layer(name, x, params, nhead)
    _check_sep(name, sep, x.device)
    y = torch.empty_like(x)
    r = torch.empty_like(x)
    lse = torch.empty((B, T, nhead), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, r, lse
    # The intermediates that pass between the layer's kernels, in the compute
    # dtype: qkv, attn, rc = cdt(r) (first cdt(x)), g.
    M, c = B * T, 2 if cdt == torch.bfloat16 else 4
    work, (qkv, attn, rc, g) = _workspace(x.device, (M * 3 * D, c), (M * D, c), (M * D, c), (M * F, c))
    _launch(name, x, x.data_ptr(), *(params[k].data_ptr() for k in FUSED_PARAM_ORDER), y.data_ptr(), r.data_ptr(),
            lse.data_ptr(), qkv, attn, rc, g, sep.data_ptr(), B, T, D, nhead, F, int(cdt == torch.bfloat16))
    return y, r, lse


def _workspace(device, *parts) -> tuple:
    """One allocation for a chain's scratch buffers: ``parts`` are element
    counts of 4-byte (f32) buffers, of 2-byte ones as ``(count, 2)``, or
    None for a buffer the chain does not get (a null pointer). Returns the
    workspace tensor, which the caller keeps until the launch is enqueued,
    and each part's address (None for None); every part starts on a 256-byte
    boundary. Like any scratch here it is freed once the kernels are
    enqueued: the caching allocator hands its blocks only to later work on
    this stream."""
    offsets, total = [], 0
    for part in parts:
        if part is None:
            offsets.append(None)
            continue
        count, size = part if isinstance(part, tuple) else (part, 4)
        offsets.append(total)
        total += -(-count * size // 256) * 256
    buf = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    return buf, [None if o is None else base + o for o in offsets]


def fused_layer_bwd_ffn(r: torch.Tensor, params: dict, dy: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Launch the fused layer's FFN backward (the TPU kernel
    ``_bwd_ffn_kernel``): one call, which enqueues its device kernels (ten
    in bf16, nine in f32, and an ordered sum for each weight gradient that
    :func:`weight_grad_splits` splits) on the current stream and counts one
    launch. The products by W1^T and W2^T read the weights in place.

    r: (B, T, D) float32, the forward's post-LN1 activations; dy: (B, T, D)
    float32, the gradient of y; ``params`` as :func:`fused_layer_fwd` takes
    them. Returns (dr (B, T, D) float32, {"w1", "b1", "w2", "b2", "ln2_g",
    "ln2_b": float32 gradients summed over the batch, in the JAX layout}).
    """
    name = "pfn_fused_layer_bwd_ffn"
    B, T, D, F, cdt = _check_fused_layer(name, r, params, None, [("dy", dy, torch.float32, tuple(r.shape))],
                                         backward=True)
    dev, M = r.device, B * T
    dr = torch.empty_like(r)
    # The chain writes every entry; with no rows the sums are zeros.
    new = torch.empty if r.numel() else torch.zeros
    grads = {k: new(s, dtype=torch.float32, device=dev)
             for k, s in fused_param_shapes(D, F).items() if k in ("w1", "b1", "w2", "b2", "ln2_g", "ln2_b")}
    if r.numel() == 0:
        return dr, grads
    bf16 = cdt == torch.bfloat16
    splits = _weight_grad_splits(M, ((F, D), (D, F)), dev, bf16)  # dW2, dW1
    # rc, dr2c and dh1c exist in bf16 only; dh1 (f32) in f32 only; g in the compute dtype.
    work, (rc, h1, g, r2, dr2, dr2c, dh1, dh1c, partial, wpartial) = _workspace(
        dev, (M * D, 2) if bf16 else None, M * F, (M * F, 2) if bf16 else M * F, M * D, M * D,
        (M * D, 2) if bf16 else None, None if bf16 else M * F, (M * F, 2) if bf16 else None,
        -(-M // COLSUM_ROWS) * max(3 * D, F), max(splits) * D * F)
    _launch(name, r, r.data_ptr(), *(params[k].data_ptr() for k in ("w1", "b1", "w2", "b2", "ln2_g")),
            dy.data_ptr(), dr.data_ptr(), *(grads[k].data_ptr() for k in ("w1", "b1", "w2", "b2", "ln2_g", "ln2_b")),
            rc, h1, g, r2, dr2, dr2c, dh1, dh1c, partial, wpartial, B, T, D, F, *splits, int(bf16))
    return dr, grads


def fused_layer_bwd_attn(x: torch.Tensor, params: dict, lse: torch.Tensor, dr: torch.Tensor, sep: torch.Tensor,
                         nhead: int) -> tuple[torch.Tensor, dict]:
    """Launch the fused layer's attention backward (the TPU kernel
    ``_bwd_attn_kernel``): one call, which enqueues its device kernels
    (fifteen in bf16, fourteen in f32, and an ordered sum for each weight
    gradient that :func:`weight_grad_splits` splits) on the current stream
    and counts one launch. The products by Wout^T and Wqkv^T read the
    weights in place.

    x: (B, T, D) float32, the layer's input; lse: (B, T, H) float32 from the
    forward; dr: (B, T, D) float32 from :func:`fused_layer_bwd_ffn`;
    ``params`` and ``sep`` as :func:`fused_layer_fwd` takes them. Returns (dx
    (B, T, D) float32, {"wqkv", "bqkv", "wout", "bout", "ln1_g", "ln1_b":
    float32 gradients summed over the batch, in the JAX layout}).
    """
    name = "pfn_fused_layer_bwd_attn"
    B, T, D, F, cdt = _check_fused_layer(
        name, x, params, nhead,
        [("lse", lse, torch.float32, (x.shape[0], x.shape[1], nhead)), ("dr", dr, torch.float32, tuple(x.shape))],
        backward=True)
    _check_sep(name, sep, x.device)
    dev, M, H = x.device, B * T, nhead
    dx = torch.empty_like(x)
    new = torch.empty if x.numel() else torch.zeros  # as in fused_layer_bwd_ffn
    grads = {k: new(s, dtype=torch.float32, device=dev)
             for k, s in fused_param_shapes(D, F).items() if k in ("wqkv", "bqkv", "wout", "bout", "ln1_g", "ln1_b")}
    if x.numel() == 0:
        return dx, grads
    bf16 = cdt == torch.bfloat16
    splits = _weight_grad_splits(M, ((D, D), (D, 3 * D)), dev, bf16)  # dWout, dWqkv
    ldp = -(-T // 16) * 16  # row stride of the (B*H*T, T) p and ds scratch, as in the kernel
    # partial: the LayerNorm's column sums by COLSUM_ROWS rows, and dqkv's by
    # item and 128-row tile.
    chunks = max(-(-M // COLSUM_ROWS), B * -(-T // 128))
    c = 2 if bf16 else 4  # bytes of the compute dtype
    # xc, dr1c and dqkvc exist in bf16 only, dqkv (f32) in f32 only.
    work, (xc, qkv, attn, r1, dr1, dr1c, dout, pc, ds, dqkv, dqkvc, partial, wpartial) = _workspace(
        dev, (M * D, 2) if bf16 else None, (M * 3 * D, c), (M * D, c), M * D, M * D, (M * D, 2) if bf16 else None,
        (M * D, c), (B * H * T * ldp, c), (B * H * T * ldp, c), None if bf16 else M * 3 * D,
        (M * 3 * D, 2) if bf16 else None, chunks * 3 * D, max(splits[0], 3 * splits[1]) * D * D)
    _launch(name, x, x.data_ptr(), *(params[k].data_ptr() for k in ("wqkv", "bqkv", "wout", "bout", "ln1_g")),
            lse.data_ptr(), dr.data_ptr(), sep.data_ptr(), dx.data_ptr(),
            *(grads[k].data_ptr() for k in ("wqkv", "bqkv", "wout", "bout", "ln1_g", "ln1_b")),
            xc, qkv, attn, r1, dr1, dr1c, dout, pc, ds, dqkv, dqkvc, partial, wpartial, B, T, D, H, *splits, int(bf16))
    return dx, grads
