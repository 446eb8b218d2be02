"""The run never loads JAX or the JAX package, and the reference loads
nothing of the port. Top-level names are compared whole: the port's name
begins with the JAX package's."""

import ast
import subprocess
import sys

from pfnbench import run, spec
from pfnbench.tests.conftest import ROOT

RUN_MODULES = ["pfnbench.run", "pfnbench.calibrate", "pfnbench.traffic.train", "pfnbench.traffic.score",
               "pfnbench.priors.gp", "pfnbench.priors.bnn", "pfnbench.criteria.full_bar", "pfnbench.criteria.bce",
               "pfnbench.models.pfn"]


def _loaded_after(imports: list[str]) -> set[str]:
    code = ("import sys\n" + "".join(f"import {m}\n" for m in imports)
            + "from pfnbench import spec\n"
            + "[spec.metric_reader(m['name']) for m in spec.benchmark()['per_layer']]\n"
            + "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return set(out.stdout.split())


def test_a_dry_import_of_the_run_loads_no_jax():
    loaded = _loaded_after(RUN_MODULES + ["pfn_tpu_torch.train.loop", "pfn_tpu_torch.evals.harness"])
    assert "pfn_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def test_loaded_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pfn_tpu_torch_x", sys)
    assert "pfn_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "pfn_tpu.models", sys)
    assert "pfn_tpu" in run.loaded_forbidden()


def test_the_reference_loads_nothing_of_the_port():
    files = sorted((spec.ROOT / "reference").glob("*.py"))
    modules = [f"pfnbench.reference.{f.stem}" for f in files if f.stem != "__init__"]
    loaded = _loaded_after(modules)
    assert "pfn_tpu_torch" not in loaded and not loaded & set(run.FORBIDDEN)
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("pfn_tpu_torch", "pfn_tpu", "jax") for n in names), (f, names)
