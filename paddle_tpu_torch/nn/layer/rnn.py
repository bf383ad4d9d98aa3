"""RNN layers — port of `paddle_tpu/nn/layer/rnn.py` (reference
`python/paddle/nn/layer/rnn.py`: SimpleRNN/LSTM/GRU and their cells).

The reference's time loop is a Python loop of cell calls, each one op
through `apply`; the port keeps it (a cuDNN RNN is a later speed choice).
Parameters follow Paddle's layout: weight_ih [gates * H, I], weight_hh
[gates * H, H]; the gates are i, f, g, o (LSTM) and r, z, c (GRU, with
`h @ wh.T + bh` inside the reset product).  Mixed dtypes promote as jnp
does (bf16 weights on float32 zero states give float32), which torch's
matmul needs spelled out.  `sequence_length` and `proj_size` are
accepted and ignored, as in the reference; dropout between layers draws
from the port's generator.
"""
from __future__ import annotations

import math

import torch

from ...core import dtype as _dt
from ...core.tensor import Tensor, apply
from .. import functional as F
from ..initializer import Uniform
from .layers import Layer


def _full(shape, value, like):
    """A float tensor of the default dtype on `like`'s device."""
    return Tensor(torch.full(shape, value, dtype=_dt.to_torch(
        _dt._default_dtype), device=like._t.device))


def _mm(x, w):
    """x @ w.T, promoted as jnp promotes."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt).T)


class RNNCellBase(Layer):
    def _gate_params(self, gates, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr):
        """weight_ih [gates * H, I], weight_hh [gates * H, H] and the two
        biases [gates * H], all Uniform(-1 / sqrt(H), 1 / sqrt(H))."""
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        rows = gates * hidden_size
        self.weight_ih = self.create_parameter(
            [rows, input_size], weight_ih_attr, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [rows, hidden_size], weight_hh_attr, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [rows], bias_ih_attr, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [rows], bias_hh_attr, is_bias=True, default_initializer=init)

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        B = batch_ref.shape[batch_dim_idx]
        st = self.state_shape
        if isinstance(st[0], (list, tuple)):
            return tuple(_full([B] + list(s), init_value, batch_ref)
                         for s in st)
        return _full([B] + list(st), init_value, batch_ref)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.activation = activation
        self._gate_params(1, input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = torch.tanh if self.activation == "tanh" else torch.relu

        def f(x, h, wi, wh, bi, bh):
            return act(_mm(x, wi) + bi + _mm(h, wh) + bh)
        h = apply("simple_rnn_cell", f, inputs, states, self.weight_ih,
                  self.weight_hh, self.bias_ih, self.bias_hh)
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, proj_size=0):
        super().__init__()
        self._gate_params(4, input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h0, c0 = states

        def f(x, h, c, wi, wh, bi, bh):
            gates = _mm(x, wi) + bi + _mm(h, wh) + bh
            i, fg, g, o = torch.chunk(gates, 4, dim=-1)
            i, fg = torch.sigmoid(i), torch.sigmoid(fg)
            g, o = torch.tanh(g), torch.sigmoid(o)
            c_new = fg * c + i * g
            return o * torch.tanh(c_new), c_new
        h, c = apply("lstm_cell", f, inputs, h0, c0, self.weight_ih,
                     self.weight_hh, self.bias_ih, self.bias_hh)
        return h, (h, c)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._gate_params(3, input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)

        def f(x, h, wi, wh, bi, bh):
            ir, iz, ic = torch.chunk(_mm(x, wi) + bi, 3, dim=-1)
            hr, hz, hc = torch.chunk(_mm(h, wh) + bh, 3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            c = torch.tanh(ic + r * hc)
            return (1 - z) * c + z * h
        h = apply("gru_cell", f, inputs, states, self.weight_ih,
                  self.weight_hh, self.bias_ih, self.bias_hh)
        return h, h


class RNN(Layer):
    """A cell run over a sequence, one step at a time."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        from ...ops.manipulation import stack
        axis = 0 if self.time_major else 1
        steps = inputs.shape[axis]
        states = initial_states
        outs = []
        rng = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        for tstep in rng:
            x = inputs[:, tstep] if axis == 1 else inputs[tstep]
            out, states = self.cell(x, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return stack(outs, axis=axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...ops.manipulation import concat
        st_fw, st_bw = initial_states if initial_states is not None \
            else (None, None)
        out_fw, s_fw = self.rnn_fw(inputs, st_fw, sequence_length)
        out_bw, s_bw = self.rnn_bw(inputs, st_bw, sequence_length)
        return concat([out_fw, out_bw], axis=-1), (s_fw, s_bw)


class _RNNBase(Layer):
    """Multi-layer, optionally bidirectional, RNN of cells."""

    MODE = "RNN_TANH"

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, proj_size=0):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        num_dir = 2 if self.bidirect else 1
        cell_cls = {"LSTM": LSTMCell, "GRU": GRUCell,
                    "RNN_TANH": SimpleRNNCell, "RNN_RELU": SimpleRNNCell}[mode]
        from .container import LayerList
        cells = []
        for layer in range(num_layers):
            isz = input_size if layer == 0 else hidden_size * num_dir
            kw = {"activation": "relu"} if mode == "RNN_RELU" else {}
            for _ in range(num_dir):
                cells.append(cell_cls(isz, hidden_size, weight_ih_attr,
                                      weight_hh_attr, bias_ih_attr,
                                      bias_hh_attr, **kw))
        self.cells = LayerList(cells)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...ops.manipulation import concat, stack
        num_dir = 2 if self.bidirect else 1
        B = inputs.shape[1 if self.time_major else 0]
        if initial_states is None:
            shape = [self.num_layers * num_dir, B, self.hidden_size]
            initial_states = (_full(shape, 0.0, inputs),
                              _full(shape, 0.0, inputs)) \
                if self.mode == "LSTM" else _full(shape, 0.0, inputs)
        out = inputs
        final_h, final_c = [], []
        for layer in range(self.num_layers):
            dir_outs = []
            for d in range(num_dir):
                idx = layer * num_dir + d
                if self.mode == "LSTM":
                    st = (initial_states[0][idx], initial_states[1][idx])
                else:
                    st = initial_states[idx]
                rnn = RNN(self.cells[idx], is_reverse=(d == 1),
                          time_major=self.time_major)
                o, s = rnn(out, st)
                dir_outs.append(o)
                if self.mode == "LSTM":
                    final_h.append(s[0])
                    final_c.append(s[1])
                else:
                    final_h.append(s)
            out = dir_outs[0] if num_dir == 1 else concat(dir_outs, axis=-1)
            if self.dropout > 0 and layer < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        h = stack(final_h, axis=0)
        if self.mode == "LSTM":
            return out, (h, stack(final_c, axis=0))
        return out, h


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        mode = "RNN_RELU" if activation == "relu" else "RNN_TANH"
        super().__init__(mode, input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 proj_size=0, **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)
