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
