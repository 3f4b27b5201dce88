"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level module names, and the plain references load nothing of the
system under test."""

import ast
import json
import os
import subprocess
import sys

import tinycell

import core

BENCH, ROOT = tinycell.BENCH, tinycell.ROOT


def imported_top_levels(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    for base, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_whole_name_comparison_lets_the_port_pass():
    names = ["raptor_tpu_torch", "raptor_tpu_torch.ops.eval", "jaxtyping", "raptor_tpu.env",
             "jax.numpy", "jaxlib", "flax.linen", "raptor_tpu"]
    assert core.forbidden_modules(names) == ["flax.linen", "jax.numpy", "jaxlib", "raptor_tpu",
                                             "raptor_tpu.env"]


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported_top_levels(path) & set(core.FORBIDDEN), path


def test_reference_sources_import_nothing_of_the_program():
    for path in sources("reference"):
        tops = imported_top_levels(path)
        assert "raptor_tpu_torch" not in tops and not tops & set(core.FORBIDDEN), path
        assert tops <= {"__future__", "math", "typing", "torch", "reference"}, (path, tops)


def _fresh_process(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    loaded = _fresh_process(
        f"import sys, json; sys.path[:0] = [{BENCH!r}]\n"
        "import reference.quad, reference.student, reference.tf32\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "raptor_tpu_torch" not in loaded
    assert not set(loaded) & set(core.FORBIDDEN)


def test_a_run_of_each_kind_loads_no_jax():
    result = _fresh_process(
        f"import sys, json; sys.path[:0] = [{os.path.join(BENCH, 'tests')!r}]\n"
        "import tinycell, core\n"
        "for w in ('distill_train', 'eval_population'):\n"
        "    tinycell.run(w, seconds=0.2)\n"
        "print(json.dumps({'bad': core.forbidden_modules(),"
        " 'port': 'raptor_tpu_torch' in sys.modules}))")
    assert result == {"bad": [], "port": True}
