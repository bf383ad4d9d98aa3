"""Seq2seq decoding: `BeamSearchDecoder` and `dynamic_decode` — port of
`paddle_tpu/nn/decode.py` (reference `python/paddle/nn/decode.py`).

The loop runs eagerly a step at a time, with the reference's host check
of `all(finished)` after each step; the beam bookkeeping is whole-tensor
torch on the cell's device.  Top-k over the [B, W * V] scores breaks ties
toward the lower index, as `lax.top_k` does (the port's stable order, not
`torch.topk`); dead beams start at -1e9, and a finished beam extends only
by the end token, at no cost.  Tokens and lengths are int64 (the
reference's JAX, with 64-bit types off, gives int32).
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ..ops.search import _stable_order


def _raw(x):
    return x._t if isinstance(x, Tensor) else torch.as_tensor(x)


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for t in tree.values() for leaf in _leaves(t)]
    return [] if tree is None else [tree]


def _map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


class Decoder:
    """Abstract decoder interface (ref nn/decode.py Decoder)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over a step cell.

    cell: callable (inputs [B * W, D], states) -> (logits [B * W, V],
    new_states); `embedding_fn` maps token ids to the cell's inputs.
    """

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        d = _raw(x)
        tiled = torch.repeat_interleave(d[:, None], beam_size, dim=1)
        return Tensor(tiled.reshape((-1,) + tuple(d.shape[1:])))

    def initialize(self, initial_cell_states):
        states = initial_cell_states
        first = _raw(_leaves(states)[0])
        W = self.beam_size
        B = first.shape[0] // W
        dev = first.device
        tokens = torch.full((B, W), self.start_token, dtype=torch.int64,
                            device=dev)
        # only beam 0 is live at first
        live = torch.arange(W, device=dev)[None] == 0
        log_probs = torch.where(live, 0.0, -1e9) * torch.ones((B, 1),
                                                              device=dev)
        finished = torch.zeros((B, W), dtype=torch.bool, device=dev)
        return tokens, (states, log_probs, finished)

    def step(self, time, tokens, state):
        cell_states, log_probs, finished = state
        B, W = tokens.shape
        inp = Tensor(tokens.reshape(-1))
        if self.embedding_fn is not None:
            inp = self.embedding_fn(inp)
        logits, new_states = self.cell(inp, cell_states)
        # the beam bookkeeping runs off the tape, on the logits' values
        ldata = _raw(logits).detach()
        if self.output_fn is not None:
            ldata = self.output_fn(Tensor(ldata))._t
        V = ldata.shape[-1]
        step_lp = torch.log_softmax(ldata.float(), -1).reshape(B, W, V)
        # finished beams extend only by the end token, at no cost
        pen = torch.full((V,), -1e9, device=ldata.device)
        pen[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], pen[None, None], step_lp)
        flat = (log_probs[..., None] + step_lp).reshape(B, W * V)
        top_ix = _stable_order(flat, -1, True)[:, :W]              # [B, W]
        top_lp = torch.gather(flat, 1, top_ix)
        beam_ix = top_ix // V
        tok = top_ix % V
        new_finished = torch.gather(finished, 1, beam_ix) | \
            (tok == self.end_token)

        def reorder(leaf):
            d = _raw(leaf)
            d = d.reshape((B, W) + tuple(d.shape[1:]))
            d = torch.take_along_dim(
                d, beam_ix.reshape((B, W) + (1,) * (d.ndim - 2)), dim=1)
            return Tensor(d.reshape((B * W,) + tuple(d.shape[2:])))
        new_states = _map(reorder, new_states)
        return tok, (new_states, top_lp, new_finished), new_finished

    def finalize(self, outputs, final_state, seq_lens):
        return outputs, final_state


def dynamic_decode(decoder, inits=None, max_step_num=100,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run the decoder until every beam has finished or `max_step_num`
    steps (ref nn/decode.py dynamic_decode)."""
    tokens, state = decoder.initialize(inits)
    outs = []
    lengths = done = None
    for t in range(max_step_num):
        tokens, state, finished = decoder.step(t, tokens, state)
        outs.append(tokens)
        if lengths is None:
            lengths = torch.full(finished.shape, t + 1, dtype=torch.int64,
                                 device=finished.device)
            done = finished
        else:
            # beams not done yet extend to this step; done beams freeze
            lengths = torch.where(done, lengths, t + 1)
            done = done | finished
        if bool(torch.all(finished)):
            break
    out_t = Tensor(torch.stack(outs, dim=0 if output_time_major else 1))
    if return_length:
        return out_t, state, Tensor(lengths)
    return out_t, state
