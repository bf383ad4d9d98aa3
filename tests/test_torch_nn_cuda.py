"""The port's nn on the card against the port's nn on the CPU.  Marked
`cuda`: they skip without an NVIDIA GPU.  On a machine with the card and
no jax, run them without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nn_cuda.py

Every case of the CPU twin tables (`tests/torch_nn_cases.py`) runs with
`set_device("gpu:0")` against the same port call with `set_device("cpu")`
(outputs on the card, floats and gradients within the case's tolerance,
integer outputs equal); the drawing functions repeat under one seed on
the card; and `nn.MultiHeadAttention` at BERT-base's attention shape,
[16, 512, 12, 64], in bf16 and float32, launches the flash forward, dkv
and dq kernels once each for a forward and backward and composes
nothing, while an all-true bool mask takes the counted plain route to the
same values: outputs and gradients within 2e-2 (bf16; the BWD_BF16_REL of
`chip_smoke.py`) or 1e-4 (f32; BWD_F32_REL) of max(1, max|plain|).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch.incubate import kernels as K
from torch_nn_cases import ALL, RANDOM, seeded_repeats
from torch_op_cases import port_on_device
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.cuda

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    prev = P.get_device()
    P.set_device("gpu:0")
    yield "gpu:0"
    P.set_device(prev)


@pytest.mark.parametrize("case", ALL, ids=[c.name for c in ALL])
def test_nn_case_on_the_card_matches_the_cpu(dev, case):
    port_on_device(P, case, dev)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_drawing_functions_repeat_on_the_card(dev, name):
    a, b, c = seeded_repeats(P, RANDOM[name])
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def _mha_pass(mha, x, w, mask=None):
    x = P.to_tensor(x._t.detach(), stop_gradient=False)
    out = mha(x, x, x, mask)
    (out.astype("float32") * w).sum().backward()
    return out, x.grad


# k_proj.bias's exact gradient is 0 (softmax ignores a shift that every
# key shares), so in bf16 both routes leave only the rounding noise of
# dK summed over 8192 keys there; float32 holds it with the rest
NOISE_ONLY_BF16 = {"k_proj.bias"}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_multihead_attention_at_bert_base_runs_the_kernels(dev, dtype):
    P.seed(0)
    mha = P.nn.MultiHeadAttention(768, 12)
    mha.astype(dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = P.to_tensor(torch.randn(16, 512, 768, generator=g, device="cuda"))
    x = x.astype(dtype)
    w = P.to_tensor(torch.randn(16, 512, 768, generator=g, device="cuda"))
    K.reset_launches()
    out, gx = _mha_pass(mha, x, w)
    torch.cuda.synchronize()
    assert out.place == P.CUDAPlace(0) and out.dtype == x.dtype
    launches = K.launches()
    assert launches["flash_attention_fwd"] == 1
    assert launches["flash_bwd_dkv"] == 1 and launches["flash_bwd_dq"] == 1
    assert not any(K.composed_calls().values())
    grads = {n: p.grad._t.clone() for n, p in mha.named_parameters()}
    mha.clear_gradients()
    K.reset_launches()
    mask = P.to_tensor(torch.ones(16, 1, 512, 512, dtype=torch.bool,
                                  device="cuda"))
    ref, ref_gx = _mha_pass(mha, x, w, mask)
    assert K.composed_calls()["flash_attention_fused"] == 1
    assert not any(K.launches().values())
    rel = 2e-2 if dtype == "bfloat16" else 1e-4
    bad = []
    for n, got, want in [("out", out._t, ref._t), ("x.grad", gx._t, ref_gx._t)] + \
            [(n, grads[n], p.grad._t) for n, p in mha.named_parameters()]:
        if dtype == "bfloat16" and n in NOISE_ONLY_BF16:
            continue
        got, want = got.detach().float(), want.detach().float()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if err > rel * max(1.0, scale):
            bad.append((n, err, scale))
    assert bad == []
