"""The check that no measured process holds JAX or the JAX package: names
compared whole, so the program (sesa_tpu_torch) passes."""

import subprocess
import sys

from h100_bench import guard


def test_forbidden_names_are_caught_whole():
    assert guard.forbidden_modules(["jax", "numpy"]) == ["jax"]
    assert guard.forbidden_modules(["jax.numpy", "jaxlib.xla_client"]) == ["jax", "jaxlib"]
    assert guard.forbidden_modules(["sesa_tpu.ops.attention", "flax.linen"]) == [
        "flax", "sesa_tpu"]
    assert guard.forbidden_modules(["sesa_tpu_torch", "sesa_tpu_torch.runtime.session",
                                    "jaxtyping", "flaxen", "h100_bench.run"]) == []


def test_the_harness_and_the_program_load_neither():
    code = ("import sys; sys.path.insert(0, '.'); import h100_bench.run, h100_bench.calibrate; "
            "import sesa_tpu_torch.runtime.session, sesa_tpu_torch.convert; "
            "from h100_bench import guard; print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=guard.__file__.rsplit("/h100_bench/", 1)[0])
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
