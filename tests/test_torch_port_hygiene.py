"""The port stands on torch alone.

  * Every pfn_tpu_torch module imports with jax blocked, and importing
    builds, loads or launches nothing.
  * No source of the port, and not chip_smoke.py, imports jax or pfn_tpu;
    the experiments run with both blocked, and the evaluation modules import
    without sklearn, pandas, matplotlib and scipy (the card's machine).
  * The kernel wrappers refuse CPU tensors (they never fall back); the
    parallel layer catches no exception and sets no backend but NCCL.
  * A library's build hash covers every header under csrc/, so an edited
    header rebuilds the libraries that include it.
  * The ctypes argument types of every C entry point match its extern "C"
    declaration in csrc/, pointer for pointer and int for int.
  * chip_smoke.py fails, printing no result line, without a CUDA device and
    when it stands alone in a directory.
  * Every __global__ kernel under csrc/ is held to 0 bytes of spill by
    chip_smoke.py's SPILL_CHECKED or listed in its SPILL_EXEMPT with a
    reason (both read with ast, so nothing of chip_smoke.py runs).
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
from pfn_tpu_torch.native import cache
assert cache._lib is None and cache._lib_error is None, "the batch cache was built or loaded at import"
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


def test_the_walk_covers_the_parallel_layer():
    """The import walk above reaches the device-mesh modules and MoE."""
    import pkgutil

    import pfn_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(pfn_tpu_torch.__path__, "pfn_tpu_torch.")}
    assert {"pfn_tpu_torch.parallel", "pfn_tpu_torch.parallel.mesh", "pfn_tpu_torch.parallel.collectives",
            "pfn_tpu_torch.parallel.pipeline", "pfn_tpu_torch.models.moe"} <= names


def test_the_parallel_layer_has_no_fallback():
    """No source under pfn_tpu_torch/parallel/ catches an exception (so none
    can pick another backend or device after a failure), and the backend
    is NCCL unless the caller names gloo: the only place that sets it."""
    for path in sorted((PACKAGE / "parallel").glob("*.py")):
        tree = ast.parse(path.read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], path
        sets_backend = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                        and any(isinstance(t, ast.Name) and t.id == "backend" for t in n.targets)]
        assert all(isinstance(n.value, ast.Constant) and n.value.value == "nccl" for n in sets_backend), path


_EXPERIMENTS = ("gp_fitting", "fig3a_longrun", "fig3a_analytic_gap", "fig3a_robust_eval", "grid_fidelity",
                "bar_resolution_floor", "analytic_gap_decompose", "bayesian_models_custom_priors", "tabular_eval",
                "tabular_hgb_baseline", "fewshot_omniglot", "bayesopt_eval", "flagship_throughput", "profile_step",
                "batch_shape_sweep", "anomaly_10x10", "fused_ab")
# The device flag each takes: the Fig-3a ones and the measurement drivers
# --device, the evaluation, few-shot and Bayesian-optimisation drivers the
# JAX drivers' --cpu; the hgb baseline, host only as its JAX script, neither.
_DEVICE_FLAG = {"bayesian_models_custom_priors": "--cpu", "tabular_eval": "--cpu", "tabular_hgb_baseline": None,
                "fewshot_omniglot": "--cpu", "bayesopt_eval": "--cpu"}

_RUN_EXPERIMENT_HELP = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["pfn_tpu"] = None
name = sys.argv[1]
sys.argv = [name, "--help"]
try:
    runpy.run_module("pfn_tpu_torch.experiments." + name, run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m, mod in sys.modules.items()
             if mod is not None and (m == "pfn_tpu" or m.startswith(("pfn_tpu.", "jax"))))
assert not bad, bad
assert "pfn_tpu_torch.evals.oracles" in sys.modules
"""


@pytest.mark.parametrize("name", _EXPERIMENTS)
def test_experiments_run_with_jax_and_pfn_tpu_blocked(name):
    """Each experiment (the Fig-3a ones, the evaluation, few-shot and
    Bayesian-optimisation drivers), as
    ``python -m pfn_tpu_torch.experiments.<name>``, loads with jax and the
    JAX package blocked (its evals and experiments modules import neither),
    and its sources are among the files test_no_jax_import reads."""
    assert PACKAGE / "experiments" / f"{name}.py" in set(PACKAGE.rglob("*.py"))
    proc = subprocess.run([sys.executable, "-c", _RUN_EXPERIMENT_HELP, name], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    flag = _DEVICE_FLAG.get(name, "--device")
    assert all((f == flag) == (f in proc.stdout) for f in ("--cpu", "--device"))


_IMPORT_WITHOUT_HOST_PACKAGES = """
import sys
for name in ("jax", "pfn_tpu", "sklearn", "pandas", "matplotlib", "scipy", "seaborn", "openml", "xgboost",
             "catboost"):
    sys.modules[name] = None
import pfn_tpu_torch.data, pfn_tpu_torch.evals.tabular, pfn_tpu_torch.evals.comparison, pfn_tpu_torch.presentation
from pfn_tpu_torch.evals import tabular
try:
    tabular.logistic_metric(None, None, None, None, [])
except ImportError as e:
    print("ImportError:", e)
"""


def test_eval_modules_import_without_sklearn_pandas_matplotlib_scipy():
    """As on the card's machine: the data loaders, the tabular evaluation,
    the comparison harness and the heatmaps import with sklearn, pandas,
    matplotlib, scipy and seaborn hidden, and a baseline that needs sklearn
    raises ImportError only when it is called."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_WITHOUT_HOST_PACKAGES], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ImportError:" in proc.stdout and "sklearn" in proc.stdout


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


CSRC = PACKAGE / "ops" / "csrc"
# template <...> (optional), __global__ void, __launch_bounds__(...) (optional), the name.
_KERNEL = re.compile(r"(template\s*<[^>]*>\s*)?__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def _kernels() -> list:
    """(name, is a template, file) of every __global__ kernel in csrc/."""
    return [(m.group(2), bool(m.group(1)), path.name) for path in sorted(CSRC.glob("*.cu*"))
            for m in _KERNEL.finditer(path.read_text())]


def _smoke_constant(name: str):
    """A literal assigned at the top level of chip_smoke.py, by ast."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", None) == name:
            return ast.literal_eval(node.value)
    raise AssertionError(f"chip_smoke.py assigns no {name}")


def test_every_kernel_declaration_is_read():
    declared = sum(path.read_text().count("__global__") for path in CSRC.glob("*.cu*"))
    names = [name for name, _, _ in _kernels()]
    assert len(names) == declared and len(set(names)) == len(names), names


@pytest.mark.parametrize("name,template,source", _kernels(), ids=[name for name, _, _ in _kernels()])
def test_kernel_is_spill_checked_or_exempt(name, template, source):
    # ptxas reports a template kernel demangled as name<...>(...), any other as name(...).
    demangled = name + ("<" if template else "(")
    checked = any(tag in demangled for tag in _smoke_constant("SPILL_CHECKED"))
    reason = _smoke_constant("SPILL_EXEMPT").get(name)
    assert checked or (isinstance(reason, str) and reason.strip()), f"{source}: {name} is neither checked nor exempt"
    assert not (checked and reason), f"{name} is both checked and exempt"


def test_spill_exempt_names_kernels():
    assert set(_smoke_constant("SPILL_EXEMPT")) <= {name for name, _, _ in _kernels()}
