"""The port stands on torch alone.

  * Every pfn_tpu_torch module imports with jax blocked, and importing
    builds, loads or launches nothing.
  * No source of the port, and not chip_smoke.py, imports jax or pfn_tpu.
  * The kernel wrappers refuse CPU tensors (they never fall back).
  * A library's build hash covers every header under csrc/, so an edited
    header rebuilds the libraries that include it.
  * The ctypes argument types of every C entry point match its extern "C"
    declaration in csrc/, pointer for pointer and int for int.
  * chip_smoke.py fails, printing no result line, without a CUDA device and
    when it stands alone in a directory.
"""

import ast
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "pfn_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import pfn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pfn_tpu_torch.__path__, "pfn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from pfn_tpu_torch.ops import _ext
assert not _ext._libs, "a library was loaded at import"
assert sum(_ext.launch_counts.values()) == 0
bad = sorted(m for m, mod in sys.modules.items()
             if mod is not None and (m == "pfn_tpu" or m.startswith(("pfn_tpu.", "jax", "triton"))))
assert not bad, bad
print(len(names))
"""


def test_every_module_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "flax", "optax", "pfn_tpu"}


def test_kernel_wrapper_refuses_cpu_tensors():
    from pfn_tpu_torch.ops import _ext

    q = torch.zeros(2, 8, 32)
    rows = torch.zeros(2, 8)
    sep = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _ext.flash_fwd(q, q, q, sep, True)
    with pytest.raises(ValueError, match="CUDA"):
        _ext.flash_bwd_dq(q, q, q, q, rows, rows, sep, True)
    with pytest.raises(ValueError, match="CUDA"):
        _ext.flash_bwd_dkv(q, q, q, q, rows, rows, sep, False)
    params = {k: torch.zeros(s) for k, s in _ext.fused_param_shapes(32, 48).items()}
    with pytest.raises(ValueError, match="CUDA"):
        _ext.fused_layer_fwd(torch.zeros(2, 8, 32), params, sep, 2)
    with pytest.raises(ValueError, match="CUDA"):
        _ext.fused_layer_bwd_ffn(torch.zeros(2, 8, 32), params, torch.zeros(2, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        _ext.fused_layer_bwd_attn(torch.zeros(2, 8, 32), params, torch.zeros(2, 8, 2), torch.zeros(2, 8, 32), sep, 2)
    assert set(_ext.launch_counts) == {"pfn_flash_fwd", "pfn_flash_bwd_dq", "pfn_flash_bwd_dkv",
                                       "pfn_fused_layer_fwd", "pfn_fused_layer_bwd_ffn", "pfn_fused_layer_bwd_attn"}
    assert sum(_ext.launch_counts.values()) == 0
    assert not _ext._libs


def _run_smoke(cwd: Path, home: Path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(home)}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    proc = _run_smoke(ROOT, tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path, tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    """Every header under csrc/ is in _ext.HEADERS, and editing a copy of
    pfn_flash_sm90.cuh changes the flash libraries' paths (no nvcc needed)."""
    from pfn_tpu_torch.ops import _ext

    csrc = PACKAGE / "ops" / "csrc"
    assert {h.name for h in _ext.HEADERS} == {h.name for h in csrc.glob("*.cuh")}
    copy = tmp_path / "csrc"
    shutil.copytree(csrc, copy)
    monkeypatch.setattr(_ext, "SOURCES", {name: copy / src.name for name, src in _ext.SOURCES.items()})
    monkeypatch.setattr(_ext, "HEADERS", tuple(copy / h.name for h in _ext.HEADERS))
    before = {name: _ext.library_path(name) for name in ("pfn_flash_fwd", "pfn_flash_bwd")}
    assert before == {name: _ext.library_path(name) for name in before}
    header = copy / "pfn_flash_sm90.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = {name: _ext.library_path(name) for name in before}
    assert all(after[name] != before[name] for name in before)
    assert all(path.parent == _ext.BUILD_DIR for path in after.values())


def _c_entry_points(path: Path) -> dict:
    """{name: "PPI..P"} of the extern "C" functions in a .cu source: P for a
    pointer parameter, I for an int."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
        kinds = []
        for param in (p.strip() for p in params.split(",")):
            assert "*" in param or param.startswith("int "), (name, param)
            kinds.append("P" if "*" in param else "I")
        out[name] = "".join(kinds)
    return out


def test_ctypes_signatures_match_the_c_entry_points():
    from pfn_tpu_torch.ops import _ext

    declared = {}
    for source, path in _ext.SOURCES.items():
        for name, kinds in _c_entry_points(path).items():
            declared[name] = (source, kinds)
    assert set(declared) == set(_ext._SIGNATURES)
    for name, (source, argtypes) in _ext._SIGNATURES.items():
        kinds = "".join("P" if t is ctypes.c_void_p else "I" if t is ctypes.c_int else "?" for t in argtypes)
        assert declared[name] == (source, kinds), name
