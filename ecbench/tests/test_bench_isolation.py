"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import subprocess
import sys

from ecbench import harness, registry

SOURCES = sorted(p for p in registry.HERE.rglob("*.py")
                 if "tests" not in p.parts and "_run" not in p.parts)


def test_names_are_compared_whole():
    mods = {"seaweedfs_tpu_torch": 1, "seaweedfs_tpu_torch.ops": 1,
            "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"seaweedfs_tpu.ops": 1, "jax": 1, "jaxlib.xla": 1,
                 "flax": 1})
    assert harness.forbidden_modules(mods) == [
        "flax", "jax", "jaxlib.xla", "seaweedfs_tpu.ops"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in SOURCES:
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, (
                path, name)


def test_the_reference_imports_nothing_of_the_program():
    reg = registry.Registry()
    paths = {registry.HERE.parent / c.get("reference",
                                          "ecbench/reference.py")
             for c in (reg.cell(n).config for n in reg.cell_names())}
    for path in paths:
        assert {n.split(".")[0] for n in _imports(path)} <= {
            "__future__", "functools", "numpy", "torch"}, path
    code = ("import sys; import ecbench.reference; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('seaweedfs')))")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=registry.HERE.parent)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; from ecbench import harness, control, run; "
            "import seaweedfs_tpu_torch.storage.ec_files; "
            "print(harness.forbidden_modules())")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=registry.HERE.parent)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"


def test_no_source_reads_the_jax_eras_measurements():
    for path in SOURCES:
        text = path.read_text()
        for name in ("bench.py", "chip_smoke", "BENCH_"):
            assert name not in text, (path, name)
