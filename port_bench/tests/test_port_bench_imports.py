"""No run of the benchmark loads ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` (top-level names compared whole: ``repro_torch`` is the
port), and the plain reference loads nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys

from tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_imports_the_jax_package():
    for path in (ROOT / "port_bench").rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path
    for path in (ROOT / "port_bench" / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)) | {""}, path


def _modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    code = (f"import sys; sys.path[:0] = ['port_bench/tests', 'src', '.']\n"
            f"from pathlib import Path\nfrom tiny import tiny_root\nfrom port_bench import run\n"
            f"spec = run.load_cell('snn6400-eval-b4096', tiny_root(Path({str(tmp_path)!r})))\n"
            f"run.run_cell(spec, 3, 0.0, 0, 'cpu')\n")
    loaded = _modules_after(code)
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _modules_after("import sys; sys.path[:0] = ['.']\n"
                            "import port_bench.reference.snn\nimport port_bench.check")
    assert not loaded & (FORBIDDEN | {"repro_torch"})
