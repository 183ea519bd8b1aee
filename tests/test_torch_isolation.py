"""The port stands alone: mxnet_tpu_torch, chip_smoke.py and the port's
scripts (scripts/torch_*.py) import neither jax nor the JAX package,
and the port's entry points default to the CUDA card (raising on a
machine without one)."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "mxnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")

PROBE = """
import sys
import chip_smoke
import torch
import mxnet_tpu_torch
from mxnet_tpu_torch import _build, telemetry, tracing
from mxnet_tpu_torch.ops import attention, nn, quantized, sampling
from mxnet_tpu_torch.serving import paging
from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel, load_jax_params
from mxnet_tpu_torch.serving import GenerationEngine
from mxnet_tpu_torch import (autograd, operator, rtc, engine, numpy,
                             numpy_extension, ndarray, random_state,
                             optimizer, lr_scheduler, parallel)
from mxnet_tpu_torch.gluon import loss
from mxnet_tpu_torch.parallel import TrainStep
import mxnet_tpu_torch as mx
assert mx.np is numpy and mx.npx is numpy_extension and mx.nd is ndarray
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
print("BAD", bad)
with open("/proc/self/maps") as f:
    print("NVRTC", "libnvrtc" in f.read())
print("CUDA_INIT", torch.cuda.is_initialized())
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_import_leaves_jax_and_reference_out():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    # importing loads no NVRTC and touches no device
    assert "NVRTC False" in r.stdout and "CUDA_INIT False" in r.stdout, \
        r.stdout


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "scripts").glob("torch_*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports_in_source(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result,
    both in the repository and alone in an empty directory."""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_entry_points_default_to_cuda():
    import torch
    from mxnet_tpu_torch.context import resolve_device
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule under test is "
                    "the CUDA-less refusal")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTModel(vocab_size=50, units=16, num_layers=1, num_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_import_builds_nothing():
    """Importing the package neither compiles nor loads a kernel."""
    from mxnet_tpu_torch import _build
    assert _build._libs == {} or all(
        n in _build.KERNEL_SOURCES for n in _build._libs)
    assert set(_build.KERNEL_SOURCES) == {
        "flash_attention", "flash_attention_bwd", "decode_attention",
        "paged_decode_attention", "dequant_matmul"}
    for src in _build.KERNEL_SOURCES.values():
        assert (_build.CSRC / src).is_file()
