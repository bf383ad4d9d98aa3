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
One AdamW step and one Lamb step (with a global-norm clip and a
scheduler) give the CPU's parameters and moments within 1e-6 of
max(1, max|cpu|) (the smoke's OPT_F32_REL); a float32 beam decode over a
GRUCell gives the CPU's tokens at every step up to the first whose
candidates lie within 1e-4 of each other.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch.incubate import kernels as K
import torch_nn_cases as C
from torch_nn_cases import ALL, RANDOM, seeded_repeats
from torch_op_cases import port_on_device
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.cuda

@pytest.fixture
def dev():
    """The card, with TF32 off for matmuls and cuDNN's convolutions (both
    flags restored after)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prev = P.get_device()
    P.set_device("gpu:0")
    yield "gpu:0"
    P.set_device(prev)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = flags


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


OPT_F32_REL = 1e-6
_o = np.random.RandomState(53)
OPT_SHAPES = [(64, 48), (48,), (300,)]
OPT_INIT = [_o.randn(*s).astype(np.float32) for s in OPT_SHAPES]
OPT_GRADS = [_o.randn(*s).astype(np.float32) for s in OPT_SHAPES]


def _one_step(name, place):
    P.set_device(place)
    ps = [P.to_tensor(a, stop_gradient=False) for a in OPT_INIT]
    for i, p in enumerate(ps):
        p.name = f"w{i}"
    lr = P.optimizer.lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-2, 6), 2, 0.0, 1e-2)
    sched.step()            # warmup's second value: a step that moves
    clip = P.nn.ClipGradByGlobalNorm(1.0)
    if name == "AdamW":
        opt = P.optimizer.AdamW(sched, parameters=ps, weight_decay=0.01,
                                grad_clip=clip)
    else:
        opt = P.optimizer.Lamb(sched, parameters=ps, grad_clip=clip)
    for p, g in zip(ps, OPT_GRADS):
        p.grad = P.to_tensor(g)
    opt.step()
    out = {p.name: p._t.detach().cpu() for p in ps}
    for acc in ("moment1", "moment2"):
        for p in ps:
            a = opt._accumulators[acc][id(p)]
            assert a.dtype == torch.float32 and a.device == p._t.device
            out[f"{p.name}_{acc}"] = a.cpu()
    return out


@pytest.mark.parametrize("name", ["AdamW", "Lamb"])
def test_one_optimizer_step_on_the_card_matches_the_cpu(dev, name):
    got = _one_step(name, dev)
    want = _one_step(name, "cpu")
    P.set_device(dev)
    bad = []
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        if err > OPT_F32_REL * max(1.0, float(w.abs().max())):
            bad.append((k, err))
    assert bad == []


class _Watched(P.nn.BeamSearchDecoder):
    """A BeamSearchDecoder that keeps each step's beam log-probs and
    finished marks as they enter the step (the last one built in `last`)."""

    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seen = []
        _Watched.last = self

    def step(self, time, tokens, state):
        self.seen.append((state[1].cpu(), state[2].cpu()))
        return super().step(time, tokens, state)


def _margins(seen, logits, beam):
    """Each step's smallest gap among the top beam + 1 candidates."""
    out = []
    for (lp, fin), lg in zip(seen, logits):
        B = lp.shape[0]
        step_lp = torch.log_softmax(lg.float(), -1).reshape(B, beam, -1)
        pen = torch.full((step_lp.shape[-1],), -1e9)
        pen[C.DEC_END] = 0.0
        step_lp = torch.where(fin[..., None], pen, step_lp)
        flat = (lp[..., None] + step_lp).reshape(B, -1)
        top = torch.sort(flat, -1, descending=True).values[:, :beam + 1]
        out.append(float((top[:, :-1] - top[:, 1:]).min()))
    return out


def _decode(place, weights, beam):
    P.set_device(place)
    cell, _ = C.decode_layers(P, *weights[:5])
    logits = []

    def cell_fn(inp, states):
        out, new = cell(inp, states)
        logits.append(out._t.detach().cpu())
        return out, new
    ts = [P.to_tensor(w) for w in weights]
    out = C.beam_decode(P, *ts, cell_fn=cell_fn, decoder=_Watched,
                        beam=beam, steps=12)
    return out[0]._t.cpu(), _margins(_Watched.last.seen, logits, beam)


def test_beam_decode_on_the_card_matches_the_cpu(dev):
    beam = 4
    weights = C.decode_weights(np.random.RandomState(59), B=3, V=32, D=16,
                               tie=False)
    got, _ = _decode(dev, weights, beam)
    want, margins = _decode("cpu", weights, beam)
    P.set_device(dev)
    assert got.dtype == torch.int64
    compared = 0
    for t, margin in enumerate(margins):
        if margin <= 1e-4:
            break
        assert torch.equal(got[:, t], want[:, t]), t
        compared += 1
    assert compared >= 1
