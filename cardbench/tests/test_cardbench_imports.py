"""The import guard: importing every module of the benchmark, and the port
through it, loads neither JAX nor the ``radler_tpu`` package; the
references load nothing of the port."""

import ast
import subprocess
import sys

from cardbench.harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "radler_tpu")


def _modules(folder):
    return sorted(p for p in (spec.BENCH_DIR / folder).glob("*.py"))


def _probe(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(p.stdout.split())


def test_nothing_loads_jax_or_the_jax_package():
    mods = ["cardbench.run", "cardbench.calibrate"]
    mods += [f"cardbench.harness.{p.stem}" for p in _modules("harness")]
    mods += [f"cardbench.reference.{p.stem}" for p in _modules("reference")]
    readers = [p.stem for p in _modules("metrics")]
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from cardbench.harness import spec\n"
        f"for r in {readers!r}: spec.metric_reader(r)\n"
        "import radler_tpu_torch, radler_tpu_torch.radler\n"
        "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))\n"
    )
    tops = _probe(code)
    assert "radler_tpu_torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_references_import_nothing_of_the_port():
    for path in _modules("reference"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in (
                    "radler_tpu_torch",) + FORBIDDEN, (path, name)
    mods = [f"cardbench.reference.{p.stem}" for p in _modules("reference")]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))")
    tops = _probe(code)
    assert "radler_tpu_torch" not in tops and not tops & set(FORBIDDEN)
