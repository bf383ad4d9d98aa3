"""Every Layer class of the port's `nn` slice (`paddle_tpu_torch/nn/layer/`
activation, common, container, norm, loss and transformer; `nn/clip.py`;
`nn/utils`) against the JAX package's, on the CPU.

Each case builds the layer in both packages, carries the reference's
parameters and buffers into the port's (`tests/torch_nn_cases.py::carry`,
through the port's `set_state_dict`), runs the same numpy inputs through
both, and holds the outputs, the input gradients and every parameter's
gradient of the summed float outputs at float32 2e-5 abs and rel.
`MultiHeadAttention` runs self- and cross-attention (`kdim`/`vdim`) with
bool and additive masks; its `Cache` decodes step by step equal to the
masked full pass, and its `StaticCache` equals the uncached cross pass;
the encoder, decoder and `Transformer` run with `normalize_before` both
ways; BatchNorm's running statistics move in training and serve in eval.
"""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
import torch_nn_cases as C
from torch_nn_cases import carry
from torch_op_cases import flat_outputs, is_float
from torch_op_test import on_cpu  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
_r = np.random.RandomState(17)


def f32(*shape, scale=1.0):
    return (_r.randn(*shape) * scale).astype(np.float32)


def close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if is_float(want):
        np.testing.assert_allclose(got, want, **TOL, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def run(ns, layer, inputs, call, grad):
    ts = [ns.to_tensor(a, stop_gradient=not (grad and is_float(a)))
          for a in inputs]
    outs = flat_outputs(call(layer, *ts))
    if grad:
        loss = None
        for o in outs:
            if hasattr(o, "numpy") and is_float(o.numpy()) and \
                    not o.stop_gradient:
                loss = o.sum() if loss is None else loss + o.sum()
        loss.backward()
    vals = [np.asarray(o.numpy() if hasattr(o, "numpy") else o)
            for o in outs]
    gin = [None if t.grad is None else t.grad.numpy() for t in ts]
    gp = {n: None if p.grad is None else p.grad.numpy()
          for n, p in layer.named_parameters()}
    return vals, gin, gp


def layer_twin(build, inputs, call=None, grad=True, train=False):
    """Build, carry, run and compare; returns the port's layer."""
    call = call or (lambda layer, *ts: layer(*ts))
    ref = build(R)
    port = carry(ref, build(P))
    for lyr in (ref, port):
        lyr.train() if train else lyr.eval()
    want = run(R, ref, inputs, call, grad)
    got = run(P, port, inputs, call, grad)
    assert len(got[0]) == len(want[0])
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        close(g, w, f"output {i}")
    if grad:
        for i, (g, w) in enumerate(zip(got[1], want[1])):
            assert (g is None) == (w is None), f"input grad {i}"
            if w is not None:
                close(g, w, f"input grad {i}")
        assert got[2].keys() == want[2].keys()
        for n in want[2]:
            assert (got[2][n] is None) == (want[2][n] is None), n
            if want[2][n] is not None:
                close(got[2][n], want[2][n], f"grad {n}")
    return ref, port


X = f32(3, 8)
XK = np.where(np.abs(X) < 0.05, 0.3, X).astype(np.float32)
IMG = f32(2, 4, 3, 3)

ACTIVATIONS = {
    "CELU": ((), X), "ELU": ((0.5,), X), "GELU": ((True,), X),
    "Hardshrink": ((), XK), "Hardsigmoid": ((), XK), "Hardswish": ((), XK),
    "Hardtanh": ((), XK), "LeakyReLU": ((0.1,), XK), "LogSigmoid": ((), X),
    "LogSoftmax": ((), X), "Maxout": ((2,), IMG), "Mish": ((), X),
    "ReLU": ((), XK), "ReLU6": ((), XK * 4), "RReLU": ((), XK),
    "SELU": ((), X), "Sigmoid": ((), X), "Silu": ((), X),
    "Softmax": ((0,), X), "Softplus": ((), X), "Softshrink": ((), XK),
    "Softsign": ((), X), "Swish": ((), X), "Tanh": ((), X),
    "Tanhshrink": ((), X), "ThresholdedReLU": ((0.5,), XK),
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_layer(name):
    args, x = ACTIVATIONS[name]
    layer_twin(lambda ns: getattr(ns.nn, name)(*args), [x])


def test_prelu_and_softmax2d():
    layer_twin(lambda ns: ns.nn.PReLU(4, init=0.2),
               [np.where(np.abs(IMG) < 0.05, 0.3, IMG).astype(np.float32)])
    layer_twin(lambda ns: ns.nn.Softmax2D(), [IMG])


COMMON = {
    "Identity": (lambda ns: ns.nn.Identity(), [X]),
    "Linear": (lambda ns: ns.nn.Linear(8, 5), [X]),
    "Linear_no_bias": (lambda ns: ns.nn.Linear(8, 5, bias_attr=False), [X]),
    "Dropout": (lambda ns: ns.nn.Dropout(0.3), [X]),
    "Dropout_downscale": (lambda ns: ns.nn.Dropout(
        0.3, mode="downscale_in_infer"), [X]),
    "Dropout2D": (lambda ns: ns.nn.Dropout2D(0.3), [IMG]),
    "Dropout3D": (lambda ns: ns.nn.Dropout3D(0.3), [f32(1, 2, 2, 2, 2)]),
    "AlphaDropout": (lambda ns: ns.nn.AlphaDropout(0.3), [X]),
    "Flatten": (lambda ns: ns.nn.Flatten(), [IMG]),
    "Unflatten": (lambda ns: ns.nn.Unflatten(1, [2, 4]), [X]),
    "Upsample": (lambda ns: ns.nn.Upsample(scale_factor=2, mode="bilinear"),
                 [IMG]),
    "UpsamplingBilinear2D": (lambda ns: ns.nn.UpsamplingBilinear2D(
        size=[5, 4]), [IMG]),
    "UpsamplingNearest2D": (lambda ns: ns.nn.UpsamplingNearest2D(
        scale_factor=2), [IMG]),
    "Bilinear": (lambda ns: ns.nn.Bilinear(8, 8, 3), [X, f32(3, 8)]),
    "Pad1D": (lambda ns: ns.nn.Pad1D([1, 2], mode="reflect"), [f32(2, 3, 5)]),
    "Pad2D": (lambda ns: ns.nn.Pad2D([1, 0, 2, 1], value=0.5), [IMG]),
    "Pad3D": (lambda ns: ns.nn.Pad3D([1, 1, 0, 1, 1, 0], mode="replicate"),
              [f32(1, 2, 2, 3, 3)]),
    "ZeroPad2D": (lambda ns: ns.nn.ZeroPad2D(1), [IMG]),
    "CosineSimilarity": (lambda ns: ns.nn.CosineSimilarity(axis=-1),
                         [X, f32(3, 8)]),
    "PairwiseDistance": (lambda ns: ns.nn.PairwiseDistance(p=3.0),
                         [X, f32(3, 8)]),
    "Unfold": (lambda ns: ns.nn.Unfold(2, strides=1, paddings=1), [IMG]),
    "Fold": (lambda ns: ns.nn.Fold([3, 3], 2), [f32(2, 8, 4)]),
}


@pytest.mark.parametrize("name", sorted(COMMON))
def test_common_layer(name):
    build, inputs = COMMON[name]
    layer_twin(build, inputs)


def test_dropout_layers_draw_in_training_and_pass_in_eval():
    for ns in (R, P):
        x = ns.to_tensor(np.ones((40, 40), np.float32))
        for layer in (ns.nn.Dropout(0.5), ns.nn.Dropout2D(0.5),
                      ns.nn.AlphaDropout(0.5)):
            y = layer(x.reshape([10, 4, 8, 5]) if isinstance(
                layer, ns.nn.Dropout2D) else x)
            assert not np.allclose(y.numpy(), 1.0)
            layer.eval()
            assert np.allclose(layer(x).numpy(), 1.0)


def test_embedding_padding_idx():
    ids = np.array([[1, 2, 0], [3, 9, 2]], np.int64)
    for ns in (R, P):
        emb = ns.nn.Embedding(10, 4, padding_idx=-8)
        assert emb._padding_idx == 2
        np.testing.assert_array_equal(emb.weight.numpy()[2], 0.0)
    _, port = layer_twin(lambda ns: ns.nn.Embedding(10, 4, padding_idx=2),
                         [ids])
    np.testing.assert_array_equal(port.weight.grad.numpy()[2], 0.0)


def test_containers():
    def build(ns):
        seq = ns.nn.Sequential(("fc", ns.nn.Linear(8, 6)), ("act", ns.nn.Tanh()))
        net = ns.nn.Sequential(seq, ns.nn.LayerList([ns.nn.Linear(6, 6)]))
        return net
    for ns in (R, P):
        net = build(ns)
        assert isinstance(net[0][:1], ns.nn.Sequential) and len(net) == 2
        ll = ns.nn.LayerList([ns.nn.Linear(2, 2)])
        ll.insert(0, ns.nn.ReLU())
        ll.extend([ns.nn.Tanh()])
        assert [type(m).__name__ for m in ll] == ["relu", "Linear", "tanh"]
        assert isinstance(ll[-1], ns.nn.Tanh) and len(ll[1:]) == 2
        pl = ns.nn.ParameterList([ns.create_parameter([2], "float32")])
        pl.append(ns.create_parameter([3], "float32"))
        assert len(pl) == 2 and [p.shape for p in pl] == [[2], [3]]
        ld = ns.nn.LayerDict({"a": ns.nn.ReLU()})
        ld["b"] = ns.nn.Linear(2, 2)
        assert list(ld.keys()) == ["a", "b"] and "b" in ld
        ld.pop("a")
        assert len(ld) == 1 and len(ld.parameters()) == 2

    def call(net, x):
        return net[1][0](net[0](x))
    layer_twin(build, [X], call=call)
    keys = {ns: list(build(ns).state_dict()) for ns in (R, P)}
    assert keys[P] == keys[R]


NORMS = {
    "LayerNorm": (lambda ns: ns.nn.LayerNorm([3, 3]), [IMG]),
    "LayerNorm_no_affine": (lambda ns: ns.nn.LayerNorm(
        8, weight_attr=False, bias_attr=False), [X]),
    "BatchNorm": (lambda ns: ns.nn.BatchNorm(4, act="relu"), [IMG]),
    "BatchNorm1D": (lambda ns: ns.nn.BatchNorm1D(8), [X * 3]),
    "BatchNorm1D_NLC": (lambda ns: ns.nn.BatchNorm1D(
        8, data_format="NLC"), [f32(2, 3, 8)]),
    "BatchNorm2D": (lambda ns: ns.nn.BatchNorm2D(4), [IMG]),
    "BatchNorm3D": (lambda ns: ns.nn.BatchNorm3D(2), [f32(2, 2, 2, 3, 2)]),
    "SyncBatchNorm": (lambda ns: ns.nn.SyncBatchNorm(4), [IMG]),
    "GroupNorm": (lambda ns: ns.nn.GroupNorm(2, 4), [IMG]),
    "InstanceNorm1D": (lambda ns: ns.nn.InstanceNorm1D(3), [f32(2, 3, 5)]),
    "InstanceNorm2D": (lambda ns: ns.nn.InstanceNorm2D(4), [IMG]),
    "InstanceNorm3D": (lambda ns: ns.nn.InstanceNorm3D(2),
                       [f32(2, 2, 2, 3, 2)]),
    "LocalResponseNorm": (lambda ns: ns.nn.LocalResponseNorm(3), [IMG]),
    "SpectralNorm": (lambda ns: ns.nn.SpectralNorm([4, 6], power_iters=2),
                     [f32(4, 6)]),
    "SpectralNorm_dim1": (lambda ns: ns.nn.SpectralNorm([3, 4, 2], dim=1),
                          [f32(3, 4, 2)]),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(NORMS))
def test_norm_layer(name, train):
    build, inputs = NORMS[name]
    ref, port = layer_twin(build, inputs, train=train)
    for n, b in ref.named_buffers():
        close(dict(port.named_buffers())[n].numpy(), b.numpy(), n)


def test_batchnorm_running_statistics_across_train_and_eval():
    ref, port = layer_twin(lambda ns: ns.nn.BatchNorm2D(4, momentum=0.8),
                           [IMG * 2 + 1], train=True)
    for lyr, ns in ((ref, R), (port, P)):
        lyr(ns.to_tensor(IMG * 3 - 1))
        assert lyr._mean.stop_gradient and lyr._mean.is_leaf
    close(port._mean.numpy(), ref._mean.numpy(), "mean")
    close(port._variance.numpy(), ref._variance.numpy(), "variance")
    ref.eval(), port.eval()
    close(port(P.to_tensor(IMG)).numpy(), ref(R.to_tensor(IMG)).numpy(),
          "eval")
    both = [ns.nn.SyncBatchNorm.convert_sync_batchnorm(
        ns.nn.Sequential(ns.nn.BatchNorm2D(4))) for ns in (R, P)]
    assert [type(b[0]).__name__ for b in both] == ["SyncBatchNorm"] * 2


LOSS_INPUTS = {
    "CrossEntropyLoss": ((), [C.LOGITS, C.LAB_IGN]),
    "MSELoss": ((), [C.PAIR_A, C.PAIR_B]),
    "L1Loss": (("sum",), [C.PAIR_A, C.PAIR_B]),
    "NLLLoss": ((), [np.log(C.PROB), C.LAB]),
    "BCELoss": ((), [C.PROB, C.BIN]),
    "BCEWithLogitsLoss": ((), [C.LOGITS, C.BIN]),
    "SmoothL1Loss": ((), [C.PAIR_A, C.PAIR_B]),
    "KLDivLoss": (("batchmean",), [np.log(C.PROB), C.PROB]),
    "MarginRankingLoss": ((0.1,), [C.PAIR_A[:, 0], C.PAIR_B[:, 0],
                                   C.SIGN[:4]]),
    "CTCLoss": ((), [C.CTC_LOGP[:, :2], C.CTC_LABELS[:2], C.CTC_IN[:2],
                     C.CTC_LL[:2]]),
    "HingeEmbeddingLoss": ((), [C.PAIR_A[:, 0], C.SIGN_INT[:4]]),
    "CosineEmbeddingLoss": ((0.1,), [C.PAIR_A, C.PAIR_B, C.SIGN_INT[:4]]),
    "TripletMarginLoss": ((), [C.PAIR_A, C.PAIR_B, f32(4, 6)]),
    "MultiLabelSoftMarginLoss": ((), [C.LOGITS, C.BIN]),
    "SoftMarginLoss": ((), [C.PAIR_A, np.sign(C.PAIR_B)]),
    "PoissonNLLLoss": ((), [C.PAIR_A, np.abs(C.PAIR_B)]),
    "GaussianNLLLoss": ((), [C.PAIR_A, C.PAIR_B, C._pos(4, 6)]),
    "MultiMarginLoss": ((), [C.LOGITS, C.LAB]),
    "TripletMarginWithDistanceLoss": ((), [C.PAIR_A, C.PAIR_B, f32(4, 6)]),
    "HSigmoidLoss": ((5, 7), [C.HS_X, C.HS_Y]),
    "RNNTLoss": ((), [C.RNNT_ACTS, C.RNNT_LABELS, np.array([4, 3], np.int64),
                      np.array([3, 2], np.int64)]),
}


@pytest.mark.parametrize("name", sorted(LOSS_INPUTS))
def test_loss_layer(name):
    args, inputs = LOSS_INPUTS[name]
    layer_twin(lambda ns: getattr(ns.nn, name)(*args), inputs)


def test_weighted_loss_layers():
    layer_twin(lambda ns: ns.nn.CrossEntropyLoss(
        weight=ns.to_tensor(C.W6), label_smoothing=0.1), [C.LOGITS, C.LAB])
    layer_twin(lambda ns: ns.nn.NLLLoss(weight=ns.to_tensor(C.W6),
                                        ignore_index=3),
               [np.log(C.PROB), C.LAB])


# ---- MultiHeadAttention and the Transformer stacks ----

D, H = 16, 4
SRC, TGT, MEM = f32(2, 5, D), f32(2, 4, D), f32(2, 6, 12)
BOOL_MASK = _r.rand(2, 1, 5, 5) > 0.3
BOOL_MASK[..., 0] = True
ADD_MASK = np.where(_r.rand(2, H, 4, 6) > 0.3, 0.0, -1e4).astype(np.float32)


def _mha(**kw):
    return lambda ns: ns.nn.MultiHeadAttention(D, H, **kw)


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_multihead_attention_self_and_cross(mask):
    if mask != "additive":
        inputs = [SRC] + ([BOOL_MASK] if mask else [])
        layer_twin(_mha(), inputs, call=lambda m, x, *k: m(x, None, None, *k))
    if mask != "bool":
        inputs = [TGT, MEM, f32(2, 6, 10)] + ([ADD_MASK] if mask else [])
        layer_twin(_mha(kdim=12, vdim=10), inputs)


def _causal(L):
    return np.triu(np.full((L, L), -1e9, np.float32), 1)


def _incremental(ns, mha, x):
    """Self-attention one step at a time through `Cache`: the steps' outputs
    stacked, and the masked full pass."""
    xt = ns.to_tensor(x)
    full = mha(xt, xt, xt, ns.to_tensor(_causal(x.shape[1])))
    cache = mha.gen_cache(xt)
    steps = []
    for i in range(x.shape[1]):
        q = ns.to_tensor(x[:, i:i + 1])
        out, cache = mha(q, q, q, None, cache)
        steps.append(out.numpy())
    assert cache.k.shape == [2, x.shape[1], H, D // H]
    return np.concatenate(steps, 1), full.numpy()


def test_multihead_attention_cache_and_static_cache():
    ref, port = layer_twin(_mha(), [SRC], call=lambda m, x: m(x))
    got = {ns: _incremental(ns, lyr, SRC) for ns, lyr in ((R, ref), (P, port))}
    for ns in (R, P):
        np.testing.assert_allclose(*got[ns], rtol=1e-5, atol=1e-5)
    close(got[P][0], got[R][0], "incremental")
    ref, port = layer_twin(_mha(kdim=12, vdim=12), [TGT, MEM],
                           call=lambda m, q, mem: m(
                               q, mem, mem, None,
                               m.gen_cache(mem, mem, m.StaticCache)))
    for ns, lyr in ((R, ref), (P, port)):
        q, mem = ns.to_tensor(TGT), ns.to_tensor(MEM)
        static = lyr.gen_cache(mem, type=lyr.StaticCache)
        out, kept = lyr(q, mem, mem, None, static)
        assert kept is static
        np.testing.assert_allclose(out.numpy(), lyr(q, mem, mem).numpy(),
                                   rtol=1e-6, atol=1e-6)


def _encoder(pre):
    def build(ns):
        layer = ns.nn.TransformerEncoderLayer(D, H, 32, dropout=0.0,
                                              activation="gelu",
                                              normalize_before=pre)
        return ns.nn.TransformerEncoder(layer, 2,
                                        ns.nn.LayerNorm(D) if pre else None)
    return build


def _decoder(pre):
    def build(ns):
        layer = ns.nn.TransformerDecoderLayer(D, H, 32, dropout=0.0,
                                              normalize_before=pre)
        return ns.nn.TransformerDecoder(layer, 2,
                                        ns.nn.LayerNorm(D) if pre else None)
    return build


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_encoder_decoder_and_transformer(pre):
    layer_twin(_encoder(pre), [SRC, BOOL_MASK])
    layer_twin(_decoder(pre), [TGT, f32(2, 5, D), _causal(4)])
    layer_twin(lambda ns: ns.nn.Transformer(
        D, H, 2, 1, 32, dropout=0.0, normalize_before=pre),
        [SRC, TGT, _causal(5), _causal(4)],
        call=lambda m, s, t, sm, tm: m(s, t, sm, tm))


def test_encoder_and_decoder_caches():
    ref, port = layer_twin(_encoder(False), [SRC], grad=False)
    for ns, enc in ((R, ref), (P, port)):
        src = ns.to_tensor(SRC)
        out, caches = enc(src, None, enc.gen_cache(src))
        assert len(caches) == 2 and caches[0].k.shape == [2, 5, H, D // H]
        np.testing.assert_allclose(out.numpy(), enc(src).numpy(), rtol=1e-6,
                                   atol=1e-6)
    ref, port = layer_twin(_decoder(True), [TGT, SRC], grad=False)
    outs = {}
    for ns, dec in ((R, ref), (P, port)):
        mem = ns.to_tensor(SRC)
        cache = dec.gen_cache(mem)
        steps = []
        for i in range(TGT.shape[1]):
            out, cache = dec(ns.to_tensor(TGT[:, i:i + 1]), mem, None, None,
                             cache)
            steps.append(out.numpy())
        full = dec(ns.to_tensor(TGT), mem, ns.to_tensor(_causal(4))).numpy()
        np.testing.assert_allclose(np.concatenate(steps, 1), full, rtol=1e-5,
                                   atol=1e-5)
        outs[ns] = full
        assert len(dec.gen_cache(mem, do_zip=True)) == 2
    close(outs[P], outs[R], "decoder")


def test_square_subsequent_mask():
    got = P.nn.Transformer.generate_square_subsequent_mask(4)
    np.testing.assert_array_equal(
        got.numpy(), R.nn.Transformer.generate_square_subsequent_mask(4).numpy())


# ---- clipping ----

def _params_grads(ns):
    ps = [ns.to_tensor(a, stop_gradient=False) for a in (f32(3, 3), f32(4))]
    gs = [ns.to_tensor(a * 4) for a in (f32(3, 3), f32(4))]
    return list(zip(ps, gs)) + [(ns.to_tensor(f32(2), stop_gradient=False),
                                 None)]


@pytest.mark.parametrize("cls,args", [("ClipGradByValue", (0.5,)),
                                      ("ClipGradByValue", (0.5, -0.2)),
                                      ("ClipGradByNorm", (1.0,)),
                                      ("ClipGradByGlobalNorm", (1.5,))])
def test_clip_classes(cls, args):
    outs = {}
    for ns in (R, P):
        _r.seed(3)
        pg = _params_grads(ns)
        out = getattr(ns.nn, cls)(*args)(pg)
        assert [p for p, _ in out] == [p for p, _ in pg] and out[-1][1] is None
        outs[ns] = [g.numpy() for _, g in out[:-1]]
    for g, w in zip(outs[P], outs[R]):
        close(g, w, cls)


def _with_grads(ns):
    net = ns.nn.Linear(4, 3)
    (net(ns.to_tensor(np.arange(8, dtype=np.float32).reshape(2, 4))) * 5) \
        .sum().backward()
    return net


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_(norm_type):
    ref = _with_grads(R)
    port = carry(ref, P.nn.Linear(4, 3))
    (port(P.to_tensor(np.arange(8, dtype=np.float32).reshape(2, 4))) * 5) \
        .sum().backward()
    totals = [ns.nn.utils.clip_grad_norm_(net.parameters(), 1.0, norm_type)
              for ns, net in ((R, ref), (P, port))]
    close(totals[1].numpy(), totals[0].numpy(), "total")
    for (n, p), (_, q) in zip(ref.named_parameters(), port.named_parameters()):
        close(q.grad.numpy(), p.grad.numpy(), n)


def test_clip_grad_value_and_vectors():
    ref = _with_grads(R)
    port = carry(ref, P.nn.Linear(4, 3))
    (port(P.to_tensor(np.arange(8, dtype=np.float32).reshape(2, 4))) * 5) \
        .sum().backward()
    for ns, net in ((R, ref), (P, port)):
        ns.nn.utils.clip_grad_value_(net.parameters(), 2.0)
    for (n, p), (_, q) in zip(ref.named_parameters(), port.named_parameters()):
        close(q.grad.numpy(), p.grad.numpy(), n)
    vecs = [ns.nn.utils.parameters_to_vector(net.parameters())
            for ns, net in ((R, ref), (P, port))]
    close(vecs[1].numpy(), vecs[0].numpy(), "vector")
    new = np.arange(15, dtype=np.float32)
    for ns, net in ((R, ref), (P, port)):
        ns.nn.utils.vector_to_parameters(ns.to_tensor(new), net.parameters())
    for (n, p), (_, q) in zip(ref.named_parameters(), port.named_parameters()):
        close(q.numpy(), p.numpy(), n)
        assert q.is_leaf and not q.stop_gradient


def test_weight_norm_and_the_identity_utils():
    ref, port = layer_twin(lambda ns: ns.nn.utils.weight_norm(
        ns.nn.Linear(4, 3), dim=1), [f32(2, 4)])
    assert sorted(n for n, _ in port.named_parameters()) == \
        ["bias", "weight_g", "weight_v"]
    for ns in (R, P):
        lyr = ns.nn.Linear(2, 2)
        assert ns.nn.utils.remove_weight_norm(lyr) is lyr
        assert ns.nn.utils.spectral_norm(lyr) is lyr
