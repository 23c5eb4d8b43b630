"""The whole-name import check, and runs that must print no result: with
no card, and in a checkout that holds only the benchmark."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from ftt_bench import registry, run


@pytest.mark.parametrize("mods,bad", [
    (["falcon_tpu_torch", "falcon_tpu_torch.ops.align"], []),
    (["falcon_tpu", "numpy"], ["falcon_tpu"]),
    (["falcon_tpu.ops.align"], ["falcon_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "flaxen", "falcon_tpu_tools"], []),
])
def test_forbidden_modules_by_whole_top_level_name(mods, bad):
    assert run.forbidden_modules(mods) == bad


def test_harness_loads_no_forbidden_module():
    code = ("import sys; sys.argv=['x']; import ftt_bench.run as r, "
            "ftt_bench.control, falcon_tpu_torch.pipeline.driver, "
            "falcon_tpu_torch.cns.device; print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _no_json(stdout):
    for line in stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "ftt_bench.run", "--workload",
         "ecoli-dp.consensus", "--seed", "1", "--seconds", "1"],
        cwd=registry.ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert _no_json(out.stdout)


def test_run_with_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copytree(registry.HERE, tmp_path / "ftt_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; from ftt_bench import registry, run; "
            "reg = registry.Registry(); "
            "r = run.run_cell(reg, reg.workload('ecoli-dp.consensus'), 1, "
            "1, 0, device='cpu', require_card=False); print(r)")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "falcon_tpu_torch" in out.stderr
    assert _no_json(out.stdout)
