"""repro_torch stands alone: it imports neither jax nor the JAX package,
its device entry points raise instead of running on the CPU when CUDA is
absent, and chip_smoke.py refuses to run without a card or without the
package beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
"""


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = _module_names()
    code = _BLOCKER + (
        "import importlib\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro') "
        "for m in sys.modules)\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_source_imports_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


@pytest.fixture
def no_cuda(monkeypatch):
    """This host as a CUDA-less one, even where a card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small_store():
    from repro_torch.data.synthetic import SensorGraphSpec, generate
    return generate(SensorGraphSpec(n_observations=60, seed=1))


def test_device_backend_raises_without_cuda(no_cuda):
    from repro_torch.api import Compactor
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Compactor(backend="device").run(_small_store())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Compactor("efsp", "device").run(_small_store())


def test_device_queries_raise_without_cuda(no_cuda):
    from repro_torch.api import Compactor
    from repro_torch.query import QueryEngine, StarQuery
    comp = Compactor()
    comp.run(_small_store())
    cid, t = next(iter(comp.fgraph.tables.items()))
    q = StarQuery(arms=((t.props[0], int(t.objects[0, 0])),), class_id=cid)
    eng = QueryEngine(comp.fgraph)
    assert eng.query_batch([q])[0].n_rows > 0        # host path still runs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eng.query_batch([q], backend="device")


def test_cpu_device_is_explicit():
    from repro_torch.api import Compactor
    comp = Compactor(backend="device", backend_opts={"device": "cpu"})
    assert comp.backend.device == torch.device("cpu")
    assert comp.run(_small_store()).plan.entries


def test_later_slices_raise_not_implemented():
    from repro_torch.api import Compactor
    with pytest.raises(NotImplementedError, match="gSpan"):
        Compactor("gspan")
    with pytest.raises(NotImplementedError, match="gSpan"):
        Compactor("efsp", detector_opts={"min_support": 2}).run(_small_store())


def test_store_from_arrays_rejects_ids_outside_dictionary():
    from repro_torch.convert import store_from_arrays
    with pytest.raises(ValueError):
        store_from_arrays(["rdf:type", "repro:instanceOf", "a"],
                          np.asarray([[0, 1, 7]], np.int32))


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_cuda():
    # CUDA_VISIBLE_DEVICES="" hides any card from the child process
    res = _run_smoke(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and res.stdout.strip() == ""


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path, {"CUDA_VISIBLE_DEVICES": "",
                                "PYTHONPATH": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
