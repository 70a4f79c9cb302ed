"""The port held to the reference's static discipline.

tools/lint.py's lock-graph (LOCKGRAPH), blocking-under-lock (SWFS005) and
broad-except (SWFS004) rules run over every module of seaweedfs_tpu_torch/
and must report nothing: the dispatch scheduler brought locks, condition
waits and broad excepts into the port. And an AST walk shows that no
module of the port, and not chip_smoke.py, imports jax or anything of
seaweedfs_tpu."""

import ast
import glob
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(glob.glob(os.path.join(REPO, "seaweedfs_tpu_torch", "**",
                                           "*.py"), recursive=True))


def _load_lint():
    spec = importlib.util.spec_from_file_location(
        "swfs_lint_port", os.path.join(REPO, "tools", "lint.py"))
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    return lint


@pytest.fixture(scope="module")
def lint():
    return _load_lint()


@pytest.mark.parametrize("rule", ["run_lockgraph_rule", "run_blocking_rule",
                                  "run_broad_except_rule"])
def test_port_passes_the_concurrency_rules(lint, rule):
    assert len(PORT_FILES) >= 20
    findings = getattr(lint, rule)(PORT_FILES)
    assert findings == [], "\n".join(findings)


def test_the_rules_see_the_port(lint, tmp_path):
    """The rules read these files: a broad except without its marker, in a
    copy of a port module, is found."""
    src = open(os.path.join(REPO, "seaweedfs_tpu_torch", "ops",
                            "dispatch.py")).read()
    bad = tmp_path / "dispatch_copy.py"
    bad.write_text(src.replace(
        "        # lint: allow-broad-except(atexit teardown must visit every\n"
        "        # scheduler; one failed close must not strand the rest)\n",
        ""))
    assert lint.run_broad_except_rule([str(bad)])


def _imported_modules(path: str) -> list[str]:
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES + [os.path.join(REPO,
                                                            "chip_smoke.py")],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_and_nothing_of_the_jax_package(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "seaweedfs_tpu"), \
            f"{os.path.relpath(path, REPO)} imports {name}"


def _device_count_calls(path: str) -> list[int]:
    """Lines of `torch.cuda.device_count()` calls (or of an import of the
    name from torch.cuda) in `path`."""
    tree = ast.parse(open(path).read(), filename=path)
    lines = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "device_count"
                and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr == "cuda"):
            lines.append(node.lineno)
        elif (isinstance(node, ast.ImportFrom) and node.module == "torch.cuda"
              and any(a.name == "device_count" for a in node.names)):
            lines.append(node.lineno)
    return lines


MESH = os.path.join(REPO, "seaweedfs_tpu_torch", "parallel", "mesh.py")


@pytest.mark.parametrize("path", [p for p in PORT_FILES if p != MESH],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_devices_are_enumerated_only_in_the_mesh_module(path):
    """The port's SWFS001: parallel/mesh.py (local_devices, device_count)
    is the one place that counts CUDA devices."""
    assert _device_count_calls(path) == [], \
        f"{os.path.relpath(path, REPO)} counts CUDA devices itself"


def test_the_device_rule_sees_the_mesh_module(tmp_path):
    assert _device_count_calls(MESH)
    bad = tmp_path / "coder_copy.py"
    bad.write_text("import torch\n\nn = torch.cuda.device_count()\n"
                   "from torch.cuda import device_count\n")
    assert sorted(_device_count_calls(str(bad))) == [3, 4]
