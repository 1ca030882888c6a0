"""Nothing under fsibench imports JAX or the JAX package, by whole
top-level module names (pyrmt_tpu_torch begins with pyrmt_tpu); a run
without a card fails and prints no result."""
import ast
import os
import subprocess
import sys

from fsibench import harness

BANNED = {"jax", "jaxlib", "flax", "pyrmt_tpu", "benchmarks"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((harness.HERE).rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not BANNED & set(_imports(f)), f


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import fsibench.harness, fsibench.calibrate, fsibench.trace; "
            "import fsibench.kinds.disc_in_cavity; "
            "import pyrmt_tpu_torch; from fsibench import run; "
            "print(run.jax_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_measurement_path_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "fsibench/run.py", "--workload",
         "soft_disc_lid_f64.n4096", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_the_script_s_directory_leaves_the_import_path():
    from fsibench import run

    path = [str(harness.HERE), "elsewhere"]
    run.use_root(path)
    assert path == [str(harness.ROOT), "elsewhere"]
