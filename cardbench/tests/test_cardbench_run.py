"""``run.py`` refuses without a card and never falls back to the CPU; the
JAX guard compares whole top-level names."""

import json
import os
import shutil
import subprocess
import sys

from cardbench import run
from cardbench.harness import spec

CELL = "clark_wideband_8k.dense_field"


def _run(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, script, "--workload", CELL, "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (ValueError, TypeError):
            pass
    return False


def test_refuses_without_a_card():
    p = _run(spec.ROOT, "cardbench/run.py")
    assert p.returncode == 3, p.stderr
    assert "CUDA" in p.stderr and "no result" in p.stderr
    assert not _has_result(p.stdout)


def test_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "cardbench/run.py")
    assert p.returncode != 0
    assert not _has_result(p.stdout)


def test_unknown_cell_is_refused():
    p = subprocess.run([sys.executable, "cardbench/run.py", "--workload",
                        "no_such.cell", "--seed", "1", "--seconds", "1"],
                       cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 2 and not _has_result(p.stdout)


def test_forbidden_modules_compare_whole_top_level_names():
    found = run.forbidden_modules([
        "radler_tpu_torch", "radler_tpu_torch.kernels", "jax_like", "jaxx",
        "flaxen", "numpy"])
    assert found == []
    assert run.forbidden_modules(["radler_tpu.models", "jaxlib.xla_client",
                                  "jax", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "radler_tpu"]
