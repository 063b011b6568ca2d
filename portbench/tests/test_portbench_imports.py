"""Nothing the benchmark runs imports JAX or the JAX package (compared
by whole top-level name), and the reference imports nothing of the
program."""

import ast

from portbench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "shadow_removal_istd_tpu"}
PORT = "shadow_removal_istd_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_jax_anywhere():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "portbench" / "reference").rglob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] != PORT, (path, name)
            assert not name.startswith(("portbench.drivers", "portbench.run")), (path, name)


def test_the_check_counts_the_port_apart_from_the_jax_package():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert PORT.startswith("shadow_removal_istd_tpu")
