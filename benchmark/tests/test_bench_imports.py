"""The check on imports, and what a run does without a card or without
the port."""

import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness.check import forbidden_modules
from benchmark.harness.manifest import ROOT, load_manifest


def test_forbidden_by_whole_top_level_name():
    assert forbidden_modules(["buildingsegment_tpu_torch",
                              "buildingsegment_tpu_torch.pipeline",
                              "jaxtyping", "flaxen", "torch"]) == []
    assert forbidden_modules(["jax", "jaxlib.xla_client", "flax.linen",
                              "buildingsegment_tpu.ops"]) == [
        "buildingsegment_tpu.ops", "flax.linen", "jax", "jaxlib.xla_client"]


def _modules_of_benchmark():
    """Every module of the benchmark's folder, by import name."""
    names = []
    bench = os.path.join(ROOT, "benchmark")
    for dirpath, _dirs, files in os.walk(bench):
        rel = os.path.relpath(dirpath, ROOT)
        if "tests" in rel.split(os.sep) or "_cache" in rel:
            continue
        for f in files:
            if f.endswith(".py") and f != "__init__.py":
                names.append(os.path.join(rel, f))
    return names


def test_nothing_the_benchmark_loads_is_jax():
    """Load every file of the benchmark (and the port's entry points it
    drives) in a fresh interpreter: no module of JAX or the JAX package
    comes with them."""
    files = _modules_of_benchmark()
    code = (
        "import importlib.util, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import benchmark.run\n"
        "import buildingsegment_tpu_torch.pipeline\n"
        "import buildingsegment_tpu_torch.dist\n"
        f"for i, f in enumerate({files!r}):\n"
        f"    spec = importlib.util.spec_from_file_location('m%d' % i, "
        f"{ROOT!r} + '/' + f)\n"
        "    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "from benchmark.harness.check import forbidden_modules\n"
        "print(forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure it")


def _run(cwd, *extra):
    cell = load_manifest()["workloads"][0]["name"]
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "4294967311", "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, cwd=cwd, timeout=300)


def test_no_card_no_result(no_card):
    out = _run(ROOT)
    assert out.returncode == 2
    assert out.stdout == ""


def test_without_the_port_no_result(tmp_path):
    """A folder that holds only the manifest and the benchmark."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout == ""
