"""The port's amp, io and save/load on the card.  Marked `cuda`: they skip
without an NVIDIA GPU.  On a machine with the card and no jax, run them
without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_amp_cuda.py

- `nn.MultiHeadAttention` at BERT-base's attention shape, [16, 512, 12,
  64], float32 parameters under `auto_cast(level="O1")`: a forward and
  backward launches the flash forward, dkv and dq kernels once each (the
  fused attention is on the white list, so q, k and v reach them in bf16),
  composes nothing and gives a bf16 output; an all-true bool mask takes the
  counted plain route, and the output and gradients lie within
  BWD_BF16_REL * max(1, max|plain|) of it (the smoke's tolerance).
- A float32 `GradScaler` + `AdamW` step (scaled grads, the clip, a
  schedule) on the card gives the CPU's parameters and moments within
  OPT_F32_REL * max(1, max|cpu|).
- `paddle.save` of card tensors and `paddle.load` on the CPU: float32 and
  bf16 bit for bit.
- A two-worker DataLoader over the shared-memory ring hands the card the
  batches of the in-process loader, bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch.incubate import kernels as K
from torch_io_cases import SquareRows
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.cuda

BWD_BF16_REL = 2e-2
OPT_F32_REL = 1e-6
# k_proj.bias's exact gradient is 0 (softmax ignores a shift that every
# key shares): in bf16 both routes leave only rounding noise there
NOISE_ONLY_BF16 = {"k_proj.bias"}


@pytest.fixture
def dev():
    """The card, with TF32 off for matmuls (restored after)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    prev = P.get_device()
    P.set_device("gpu:0")
    yield "gpu:0"
    P.set_device(prev)
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _o1_pass(mha, x, w, mask=None):
    x = P.to_tensor(x._t.detach(), stop_gradient=False)
    with P.amp.auto_cast(level="O1", dtype="bfloat16"):
        out = mha(x, x, x, mask)
    (out.astype("float32") * w).sum().backward()
    return out, x.grad


def test_o1_multihead_attention_at_bert_base_runs_the_kernels(dev):
    P.seed(0)
    mha = P.nn.MultiHeadAttention(768, 12)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = P.to_tensor(torch.randn(16, 512, 768, generator=g, device="cuda"))
    w = P.to_tensor(torch.randn(16, 512, 768, generator=g, device="cuda"))
    K.reset_launches()
    out, gx = _o1_pass(mha, x, w)
    torch.cuda.synchronize()
    assert out.dtype == P.bfloat16 and gx.dtype == P.float32
    launches = K.launches()
    assert launches["flash_attention_fwd"] == 1
    assert launches["flash_bwd_dkv"] == 1 and launches["flash_bwd_dq"] == 1
    assert not any(K.composed_calls().values())
    grads = {n: p.grad._t.clone() for n, p in mha.named_parameters()}
    assert all(t.dtype == torch.float32 for t in grads.values())
    mha.clear_gradients()
    K.reset_launches()
    mask = P.to_tensor(torch.ones(16, 1, 512, 512, dtype=torch.bool,
                                  device="cuda"))
    ref, ref_gx = _o1_pass(mha, x, w, mask)
    assert K.composed_calls()["flash_attention_fused"] == 1
    assert not any(K.launches().values())
    bad = []
    for n, got, want in [("out", out._t, ref._t),
                         ("x.grad", gx._t, ref_gx._t)] + \
            [(n, grads[n], p.grad._t) for n, p in mha.named_parameters()]:
        if n in NOISE_ONLY_BF16:
            continue
        got, want = got.detach().float(), want.detach().float()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if err > BWD_BF16_REL * max(1.0, scale):
            bad.append((n, err, scale))
    assert bad == []


_o = np.random.RandomState(61)
SHAPES = [(64, 48), (48,), (300,)]
INIT = [_o.randn(*s).astype(np.float32) for s in SHAPES]
GRADS = [_o.randn(*s).astype(np.float32) for s in SHAPES]


def _scaled_step(place):
    P.set_device(place)
    ps = [P.to_tensor(a, stop_gradient=False) for a in INIT]
    for i, p in enumerate(ps):
        p.name = f"w{i}"
    lr = P.optimizer.lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-2, 6), 2, 0.0, 1e-2)
    sched.step()
    opt = P.optimizer.AdamW(sched, parameters=ps, weight_decay=0.01,
                            grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
    scaler = P.amp.GradScaler(init_loss_scaling=1024.0)
    for p, g in zip(ps, GRADS):
        p.grad = P.to_tensor(g * 1024.0)
    scaler.step(opt)
    scaler.update()
    out = {p.name: p._t.detach().cpu() for p in ps}
    for acc in ("moment1", "moment2"):
        for p in ps:
            a = opt._accumulators[acc][id(p)]
            assert a.dtype == torch.float32 and a.device == p._t.device
            out[f"{p.name}_{acc}"] = a.cpu()
    assert scaler.get_loss_scaling() == 1024.0
    return out


def test_a_scaled_adamw_step_on_the_card_matches_the_cpu(dev):
    got = _scaled_step(dev)
    want = _scaled_step("cpu")
    P.set_device(dev)
    bad = []
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        if err > OPT_F32_REL * max(1.0, float(w.abs().max())):
            bad.append((k, err))
    assert bad == []


def test_save_on_the_card_load_on_the_cpu_is_bitwise(dev, tmp_path):
    g = torch.Generator(device="cuda").manual_seed(2)
    state = {"f32": P.to_tensor(torch.randn(64, 33, generator=g,
                                            device="cuda")),
             "bf16": P.to_tensor(torch.randn(5, 130, generator=g,
                                             device="cuda") * 300)
             .astype("bfloat16")}
    path = str(tmp_path / "card.pd")
    P.save(state, path)
    P.set_device("cpu")
    got = P.load(path)
    P.set_device(dev)
    for k, v in state.items():
        assert got[k].place == P.CPUPlace() and got[k].dtype == v.dtype
        a, b = got[k]._t, v._t.cpu()
        assert torch.equal(a.view(torch.int16) if k == "bf16" else a,
                           b.view(torch.int16) if k == "bf16" else b), k


def test_ring_loader_feeds_the_card_the_in_process_batches(dev):
    from paddle_tpu_torch.io import shm_ring
    assert shm_ring.available(), shm_ring._LIB_ERR
    sync = list(P.io.DataLoader(SquareRows(), batch_size=8))
    ring = list(P.io.DataLoader(SquareRows(), batch_size=8, num_workers=2,
                                use_shared_memory=True))
    assert len(sync) == len(ring) == 5
    for (xs, ys), (xr, yr) in zip(sync, ring):
        assert xr.place == P.CUDAPlace(0)
        assert torch.equal(xs._t, xr._t) and torch.equal(ys._t, yr._t)
