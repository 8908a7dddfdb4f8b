import ast
import os
import subprocess
import sys

import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = dict(sys.modules)
    fake.update({"loik_tpu_torch": None, "loik_tpu_torch.api": None, "jaxtyping": None})
    for name in ("jax", "jaxlib", "flax", "loik_tpu"):
        fake.pop(name, None)
    fake = {k: v for k, v in fake.items() if k.split(".")[0] not in run.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake["loik_tpu.solver"] = None
    fake["jax.numpy"] = None
    assert run.forbidden_modules() == ["jax", "loik_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert not tops & {"loik_tpu_torch", "loik_tpu", "jax", "jaxlib", "flax"}, f


def test_a_rehearsal_loads_no_jax_module():
    code = ("import sys, runpy; sys.argv = ['run.py', '--workload', 'panda_arm.plan', "
            "'--seed', '5', '--seconds', '0.2', '--rehearse', '--batch', '4'];\n"
            "import run; rc = run.main(sys.argv[1:]);\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print('TOPS', sorted(tops & {'jax', 'jaxlib', 'flax', 'loik_tpu', "
            "'loik_tpu_torch'}), rc)")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(BENCH),
                         env=dict(os.environ, PYTHONPATH=BENCH), capture_output=True,
                         text=True, timeout=300)
    assert "TOPS ['loik_tpu_torch'] 0" in out.stdout, out.stdout + out.stderr
