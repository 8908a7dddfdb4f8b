"""loik_tpu_torch, its examples (examples/torch/) and chip_smoke.py never
import jax, jaxlib or loik_tpu:
the machine with the card has no jax, and the port is held against
loik_tpu, not built on it.  The scan reads the sources (AST), because
`sys.modules` cannot tell: the test process imports jax for the parity
tests, and this environment's interpreter may import it at start-up.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "loik_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "loik_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    torch_examples = os.path.join(REPO, "examples", "torch")
    out += [os.path.join(torch_examples, f) for f in os.listdir(torch_examples)
            if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_the_scan_covers_the_package():
    names = {os.path.relpath(p, REPO) for p in _sources()}
    assert {"chip_smoke.py", "loik_tpu_torch/__init__.py",
            "loik_tpu_torch/kernels/fused.py", "loik_tpu_torch/solver/solve.py",
            "loik_tpu_torch/model/builders.py", "loik_tpu_torch/model/robots.py",
            "loik_tpu_torch/model/urdf.py", "loik_tpu_torch/convert.py",
            "loik_tpu_torch/parallel/__init__.py", "loik_tpu_torch/parallel/mixed.py",
            "loik_tpu_torch/solver/stream.py", "loik_tpu_torch/solver/clik.py",
            "loik_tpu_torch/parallel/multistart.py",
            "loik_tpu_torch/model/kinematics.py", "loik_tpu_torch/solver/diff.py",
            "loik_tpu_torch/utils/__init__.py", "loik_tpu_torch/utils/checkpoint.py",
            "loik_tpu_torch/utils/observability.py",
            "loik_tpu_torch/parallel/sharding.py", "loik_tpu_torch/parallel/distributed.py",
            "loik_tpu_torch/model/native.py", "loik_tpu_torch/oracle/__init__.py",
            "loik_tpu_torch/oracle/solver.py", "loik_tpu_torch/entry.py"} <= names
    examples = {n for n in names if n.startswith("examples/torch/")}
    assert examples == {
        "examples/torch/01_basic_solve.py", "examples/torch/02_tracking_loop.py",
        "examples/torch/03_multichip_multistart.py", "examples/torch/04_mixed_fleet.py",
        "examples/torch/05_mimic_gripper.py", "examples/torch/06_differentiable_ik.py",
        "examples/torch/07_position_ik.py"}


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{os.path.relpath(path, REPO)} imports {mod}"
