"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points never fall back to the CPU on their own."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.nn.functional import flash_attn_unpadded

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name, _ in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "paddle_tpu"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_triton_is_imported_only_by_the_lazily_loaded_kernel_module():
    """No module of the port imports triton, at top level or inside a
    function: every kernel, RMSNorm's too, is CUDA C++ that `_cuda.py`
    builds with nvcc, so the port needs no triton on any path."""
    for path in PORT_FILES:
        for name, _ in _imported_modules(path):
            assert name.split(".")[0] != "triton", path


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.inference.engine;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'));"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_refuse_to_run_without_a_card():
    """The builders default to the card; the tensor-taking entries run the
    plain versions only for CPU tensors and never for others."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = TG.gpt_tiny(32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.init_paged_cache(cfg, 4, 8)
    params = TG.init_params(cfg, torch.Generator(), device="cpu")
    for fuse in (True, False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLMEngine(params, cfg, max_model_len=32, page_size=8, fuse=fuse)
    q = torch.empty((6, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attn_unpadded(q, q, q, [0, 2, 6], [0, 2, 6], 4, 4, 0.125,
                            causal=True)


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    """No result line and a non-zero exit on a machine without CUDA, and in
    a directory holding chip_smoke.py and nothing else of the repo."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        cwd = tmp_path
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
