"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points never fall back to the CPU on their own."""
import ast
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.nn.functional import flash_attn_unpadded
from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
from torch_threads import one_torch_thread  # noqa: F401

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


CORE_NAMES = ("bool", "bfloat16", "float32", "int64", "set_default_dtype",
              "get_default_dtype", "CPUPlace", "CUDAPlace", "TPUPlace",
              "set_device", "get_device", "device_count", "Tensor",
              "to_tensor", "no_grad", "enable_grad", "set_grad_enabled",
              "is_grad_enabled", "seed", "get_rng_state_tracker",
              "get_flags", "set_flags", "grad", "autograd", "ParamAttr")


def test_core_names_import_without_jax_and_the_default_place_raises():
    """`import paddle_tpu_torch` with the eager core's top-level names
    (and the Layer API under them) pulls in no jax and no JAX package; a
    Tensor made on the default place without a card raises."""
    code = "\n".join([
        "import sys, torch, paddle_tpu_torch as P",
        f"missing = [n for n in {CORE_NAMES!r} if not hasattr(P, n)]",
        "P.autograd.PyLayer, P.nn.Layer, P.nn.initializer.Normal",
        "P.models.GPTForCausalLM, P.utils.unique_name.generate",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))",
        "raised = torch.cuda.is_available()",
        "try:",
        "    P.to_tensor([1.0])",
        "except RuntimeError as e:",
        "    raised = \"set_device('cpu')\" in str(e)",
        "print(missing, bad, raised)",
        "sys.exit(1 if missing or bad or not raised else 0)"])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# the observability plane: plain Python and torch.profiler, no jax; the
# fleet and the front door: plain Python (threading, asyncio, http.server)
OBSERVABILITY_MODULES = ("paddle_tpu_torch.inference.metrics",
                         "paddle_tpu_torch.inference.tracing",
                         "paddle_tpu_torch.inference.health",
                         "paddle_tpu_torch.profiler")
FLEET_MODULES = ("paddle_tpu_torch.inference",
                 "paddle_tpu_torch.inference.router",
                 "paddle_tpu_torch.inference.frontend",
                 "paddle_tpu_torch.inference.obs_server")
# the MoE dispatch (its own copy of the reference's plain-jnp module)
MOE_MODULES = ("paddle_tpu_torch.incubate.distributed.models.moe.dispatch",)
# tensor-parallel serving: the mesh and its workers, the serving layout;
# the trainer's pipeline schedule, expert-parallel MoE and ring attention
TP_MODULES = ("paddle_tpu_torch.parallel.tp",
              "paddle_tpu_torch.parallel.hybrid",
              "paddle_tpu_torch.parallel.mp_ops",
              "paddle_tpu_torch.parallel.pipeline",
              "paddle_tpu_torch.parallel.moe",
              "paddle_tpu_torch.parallel.ring_attention")
# the auto-parallel Engine and its checkpoints
DISTRIBUTED_MODULES = ("paddle_tpu_torch.distributed",
                       "paddle_tpu_torch.distributed.checkpoint",
                       "paddle_tpu_torch.distributed.auto_parallel",
                       "paddle_tpu_torch.distributed.auto_parallel.engine")


# the eager core, the Layer API, the op namespace and paddle.linalg
CORE_MODULES = ("paddle_tpu_torch.core.tensor", "paddle_tpu_torch.autograd",
                "paddle_tpu_torch.nn.layer.layers",
                "paddle_tpu_torch.nn.initializer", "paddle_tpu_torch.ops",
                "paddle_tpu_torch.ops.inplace", "paddle_tpu_torch.linalg")
# nn: the functional and Layer modules, and the fused attention entry
NN_MODULES = ("paddle_tpu_torch.nn", "paddle_tpu_torch.nn.functional",
              "paddle_tpu_torch.incubate.nn.functional")
# the optimizers with their schedulers, and the MoE Layer API
OPTIMIZER_MODULES = ("paddle_tpu_torch.optimizer",
                     "paddle_tpu_torch.optimizer.lr",
                     "paddle_tpu_torch.incubate.distributed.models.moe")
# amp, io with its shared-memory ring, save/load and the g++ builder
AMP_IO_MODULES = ("paddle_tpu_torch.amp", "paddle_tpu_torch.amp.grad_scaler",
                  "paddle_tpu_torch.io", "paddle_tpu_torch.io.shm_ring",
                  "paddle_tpu_torch.io.dataloader",
                  "paddle_tpu_torch.framework",
                  "paddle_tpu_torch.framework.io",
                  "paddle_tpu_torch.utils.cpp_extension")
ALONE_MODULES = OBSERVABILITY_MODULES + FLEET_MODULES + MOE_MODULES + \
    TP_MODULES + DISTRIBUTED_MODULES + CORE_MODULES + NN_MODULES + \
    OPTIMIZER_MODULES + AMP_IO_MODULES


def _import_alone(module):
    code = (f"import sys, {module};"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'));"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.fixture(scope="module")
def imported_alone():
    """`result(module)`: one fresh interpreter a module, its finished
    process.  A case starts its own module's interpreter and those of the
    next few modules in ALONE_MODULES, side by side (a few at a time, so
    that the torch imports do not crowd the machine): run in order, as on
    one worker, the interpreters overlap; a worker that runs only some
    cases starts no more than a window past each of them."""
    width = min(8, os.cpu_count() or 1)
    pool = ThreadPoolExecutor(max_workers=width)
    started = {}

    def result(module):
        at = ALONE_MODULES.index(module)
        for m in ALONE_MODULES[at:at + width]:
            if m not in started:
                started[m] = pool.submit(_import_alone, m)
        return started[module].result()
    yield result
    pool.shutdown(wait=True, cancel_futures=True)


@pytest.mark.parametrize("module", ALONE_MODULES)
def test_observability_modules_import_alone(module, imported_alone):
    """Each module of the observability plane, the fleet, the front door,
    the MoE dispatch, tensor-parallel serving and training, ring attention,
    the Engine with its checkpoints, the eager core and its ops, nn, the
    optimizers and the MoE Layer API, amp, io, save/load and the extension
    builder imports on its own and leaves jax and
    the JAX package out of sys.modules (the AST scan above covers their
    source)."""
    r = imported_alone(module)
    assert r.returncode == 0, r.stdout + r.stderr
    assert (ROOT / (module.replace(".", "/") + ".py")).exists() or \
        (ROOT / module.replace(".", "/") / "__init__.py").exists()


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
    # a training mesh starts on the cards unless given devices=
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridParallelTrainer(cfg, MeshConfig(dp=2), params=params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridParallelTrainer(cfg, MeshConfig(pp=2, ep=2), params=params)


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
