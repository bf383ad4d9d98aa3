"""The port's RNN layers and beam decoding (`paddle_tpu_torch/nn/layer/rnn.py`,
`paddle_tpu_torch/nn/decode.py`) against the JAX package's, on the CPU.

Layers cross with their weights carried (`tests/torch_nn_cases.py::carry`)
and compare outputs, final states, input gradients and every parameter's
gradient at float32 2e-5 abs and rel
(`tests/test_torch_nn_layers.py::layer_twin`): the three cells with and
without given states, `RNN` forward and reversed, `BiRNN`, and
`SimpleRNN`, `LSTM` and `GRU` at 2 layers, one way and both, batch-major
and time-major, with and without initial states.  The reference's
`SimpleRNN` stack gives its cells the attrs positionally (relu cells
whatever `activation` says, and a TypeError for `activation="relu"`); the
port does the same.
Dropout between layers draws from each package's own generator, so it is
held each package against itself.  `BeamSearchDecoder` with
`dynamic_decode` over a `GRUCell` (`torch_nn_cases.DECODE`) gives the
reference's tokens, lengths, beam log-probs and final states; its
weights make tokens 2 (the end token) and 3 tie at every step, so the
lower-index rule of `lax.top_k` decides the beams.
"""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
import torch_nn_cases as C
from test_torch_nn_layers import layer_twin
from torch_op_test import on_cpu, twin  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

_r = np.random.RandomState(37)
I, H, B, T = 3, 4, 2, 4


def f32(*shape, scale=1.0):
    return (_r.randn(*shape) * scale).astype(np.float32)


X, H0, C0 = f32(B, I), f32(B, H), f32(B, H)
SEQ = f32(B, T, I)

CELLS = {
    "SimpleRNNCell": (lambda ns: ns.nn.SimpleRNNCell(I, H), [X, H0]),
    "SimpleRNNCell_relu_zero_state": (lambda ns: ns.nn.SimpleRNNCell(
        I, H, activation="relu"), [X]),
    "LSTMCell": (lambda ns: ns.nn.LSTMCell(I, H), [X, H0, C0]),
    "LSTMCell_zero_state": (lambda ns: ns.nn.LSTMCell(I, H), [X]),
    "GRUCell": (lambda ns: ns.nn.GRUCell(I, H), [X, H0]),
    "GRUCell_zero_state": (lambda ns: ns.nn.GRUCell(I, H), [X]),
}


def _cell_call(layer, x, *states):
    if not states:
        return layer(x)
    return layer(x, states[0] if len(states) == 1 else tuple(states))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell(name):
    build, inputs = CELLS[name]
    layer_twin(build, inputs, call=_cell_call)


def test_rnn_wrapper_forward_and_reversed():
    for reverse, time_major in ((False, False), (True, True)):
        seq = np.swapaxes(SEQ, 0, 1).copy() if time_major else SEQ
        layer_twin(lambda ns: ns.nn.RNN(ns.nn.LSTMCell(I, H),
                                        is_reverse=reverse,
                                        time_major=time_major),
                   [seq, H0, C0],
                   call=lambda layer, x, h, c: layer(x, (h, c)))


def test_birnn():
    layer_twin(lambda ns: ns.nn.BiRNN(ns.nn.GRUCell(I, H),
                                      ns.nn.GRUCell(I, H)), [SEQ])
    layer_twin(lambda ns: ns.nn.BiRNN(ns.nn.SimpleRNNCell(I, H),
                                      ns.nn.SimpleRNNCell(I, H)),
               [SEQ, H0, f32(B, H)],
               call=lambda layer, x, a, b: layer(x, (a, b)))


STACKS = [(mode, direction, time_major, given)
          for mode in ("SimpleRNN", "LSTM", "GRU")
          for direction, time_major, given in (
              ("forward", False, False), ("bidirect", True, True),
              ("bidirectional", False, True))]


def _stack(ns, mode, direction, time_major):
    return getattr(ns.nn, mode)(I, H, num_layers=2, direction=direction,
                                time_major=time_major)


@pytest.mark.parametrize("mode,direction,time_major,given", STACKS,
                         ids=["-".join(map(str, s)) for s in STACKS])
def test_rnn_stack(mode, direction, time_major, given):
    num_dir = 1 if direction == "forward" else 2
    seq = np.swapaxes(SEQ, 0, 1).copy() if time_major else SEQ
    inputs = [seq]
    if given:
        inputs += [f32(2 * num_dir, B, H) for _ in
                   range(2 if mode == "LSTM" else 1)]

    def call(layer, x, *states):
        if not states:
            return layer(x)
        return layer(x, states[0] if len(states) == 1 else tuple(states))
    _, port = layer_twin(lambda ns: _stack(ns, mode, direction, time_major),
                         inputs, call=call)
    out = port(P.to_tensor(seq))
    h = out[1][0] if mode == "LSTM" else out[1]
    assert out[0].shape == ([T, B, num_dir * H] if time_major
                            else [B, T, num_dir * H])
    assert h.shape == [2 * num_dir, B, H]


@pytest.mark.parametrize("ns", [R, P], ids=["reference", "port"])
def test_simple_rnn_stacks_pass_the_cells_the_references_arguments(ns):
    """`_RNNBase` hands the cells the four attrs positionally, so a
    SimpleRNNCell takes `weight_ih_attr` (None) as its activation, which
    runs relu; `activation="relu"` then arrives twice and raises."""
    rnn = ns.nn.SimpleRNN(I, H, num_layers=2)
    assert all(cell.activation is None for cell in rnn.cells)
    with pytest.raises(TypeError, match="multiple values"):
        ns.nn.SimpleRNN(I, H, activation="relu")


@pytest.mark.parametrize("ns", [R, P], ids=["reference", "port"])
def test_stack_dropout_draws_under_the_seed(ns):
    lstm = ns.nn.LSTM(I, H, num_layers=2, dropout=0.5)
    x = ns.to_tensor(SEQ)
    lstm.train()
    outs = []
    for seed in (3, 3, 4):
        ns.seed(seed)
        outs.append(lstm(x)[0].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    lstm.eval()
    np.testing.assert_array_equal(lstm(x)[0].numpy(), lstm(x)[0].numpy())


def test_beam_search_matches_the_reference():
    got = twin(C.DECODE[0])
    tokens, h, lp, fin, lens = got
    assert tokens.shape[::2] == (C.DEC_B, C.DEC_W)
    assert tokens.dtype == np.int64 and lens.dtype == np.int64
    assert h.shape == (C.DEC_B * C.DEC_W, C.DEC_V) and lp.dtype == np.float32


def _recording_cell(ns, weights, seen):
    cell, _ = C.decode_layers(ns, *weights[:5])

    def fn(inp, states):
        out, new = cell(inp, states)
        seen.append(out.numpy())
        return out, new
    return fn


def test_beam_search_ties_go_to_the_lower_token():
    """Tokens 2 and 3 score the same at every step (their hidden units are
    twins) in both packages, and the beams pick as the reference does."""
    weights = C.decode_weights(np.random.RandomState(31))
    picks = {}
    for ns in (R, P):
        seen = []
        ts = [ns.to_tensor(w) for w in weights]
        out = C.beam_decode(ns, *ts, cell_fn=_recording_cell(ns, weights,
                                                             seen))
        assert all(np.array_equal(s[:, 2], s[:, 3]) for s in seen)
        picks[ns] = np.asarray(out[0].numpy())
    np.testing.assert_array_equal(picks[P], picks[R])
    # the end token is chosen over its twin: some beam ends on token 2
    assert (picks[P] == C.DEC_END).any()
