"""GPT family on PyTorch — port of the dense inference and paged serving
parts of `paddle_tpu/models/gpt.py`.

Plain functions over a parameter dictionary with the reference's keys and
layouts: weights `[in, out]` stacked on a leading L axis (`wte`,
`blocks/{ln1_w, qkv_w, proj_w, ln2_w, fc1_w, fcg_w, fc2_w, ...}`, `lnf_w`,
`lm_head`), attention tensors `[B, S, H, hd]`, the KV pool
`{"k", "v"}: [L, P, page, KVH, hd]` with page 0 as the null page.  Layers
run as a Python loop (the reference's `lax.scan`).  The serving programs
update the pool in place where the reference donates and rebinds it.
Attention goes through the flash and paged kernels, norms of the Llama
presets through the RMSNorm kernel; the large projections are plain
`torch.matmul`, as the reference leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..incubate.kernels.flash_attention import (flash_attention_fused,
                                                remat_policy_save_attention)
from ..incubate.kernels.paged_attention import (paged_attention_decode,
                                                paged_prefill_attention,
                                                paged_serve_attention)
from ..incubate.kernels.rms_norm import rms_norm_fused
from ..incubate.kernels.rope import apply_rope


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; without one that is an error, never a
    silent CPU run.  Pass `device="cpu"` for the plain PyTorch path."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the plain PyTorch path")
        # the indexed form, so it compares equal to a tensor's .device
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass
class GPTConfig:
    """The reference's one config for the GPT / Llama / BERT families
    (`paddle_tpu.models.gpt.GPTConfig`), with `dtype` a torch dtype."""
    vocab_size: int = 50304
    hidden_size: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    max_seq_len: int = 2048
    intermediate_size: Optional[int] = None
    use_rope: bool = True
    use_rms_norm: bool = False
    activation: str = "gelu"
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    dtype: Any = torch.float32
    num_kv_heads: Optional[int] = None
    gated_ffn: bool = False
    use_bias: bool = True
    causal: bool = True
    norm_position: str = "pre"
    embed_norm: bool = False
    final_norm: bool = True
    type_vocab_size: int = 0
    mlm_head: bool = False
    moe_num_experts: int = 0    # MoE blocks: a later slice (raises)

    @property
    def ffn_size(self):
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads

    @property
    def qkv_dim(self):
        """Packed q|k|v output width: D + 2 * kv_heads * head_dim."""
        return self.hidden_size + 2 * self.kv_heads * self.head_dim


def gpt3_1p3b():
    return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                     num_heads=16, max_seq_len=2048)


def gpt_tiny(seq_len=128):
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                     max_seq_len=seq_len)


def llama_tiny(seq_len=128):
    """RMSNorm + SwiGLU + GQA + no biases + untied head, scaled tiny."""
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, max_seq_len=seq_len, use_rms_norm=True,
                     activation="silu", gated_ffn=True, use_bias=False,
                     tie_word_embeddings=False, intermediate_size=172)


def llama2_7b():
    return GPTConfig(vocab_size=32000, hidden_size=4096, num_layers=32,
                     num_heads=32, max_seq_len=4096, use_rms_norm=True,
                     activation="silu", gated_ffn=True, use_bias=False,
                     tie_word_embeddings=False, intermediate_size=11008)


def llama3_8b():
    """Llama-3 8B shape family: GQA with 8 kv heads, 128k vocab."""
    return GPTConfig(vocab_size=128256, hidden_size=4096, num_layers=32,
                     num_heads=32, num_kv_heads=8, max_seq_len=8192,
                     use_rms_norm=True, activation="silu", gated_ffn=True,
                     use_bias=False, tie_word_embeddings=False,
                     intermediate_size=14336)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_spec(config: GPTConfig) -> Dict[str, Any]:
    """The reference `init_params` tree as {key: (shape, init)}: init is a
    normal std (float), "ones" or "zeros".  One source for `init_params`
    and the shape check of `convert.params_from_numpy`."""
    c = config
    if c.moe_num_experts > 0:
        raise NotImplementedError("MoE blocks arrive with a later slice "
                                  "(ROADMAP Queue 1: the rest of training, "
                                  "MoE and ep)")
    D, L, F_, V, Q = (c.hidden_size, c.num_layers, c.ffn_size, c.vocab_size,
                      c.qkv_dim)
    std = c.initializer_range
    proj_std = std / math.sqrt(2 * L)
    blocks = {
        "ln1_w": ((L, D), "ones"), "ln1_b": ((L, D), "zeros"),
        "qkv_w": ((L, D, Q), std), "proj_w": ((L, D, D), proj_std),
        "ln2_w": ((L, D), "ones"), "ln2_b": ((L, D), "zeros"),
        "fc1_w": ((L, D, F_), std), "fc2_w": ((L, F_, D), proj_std),
    }
    if c.gated_ffn:
        blocks["fcg_w"] = ((L, D, F_), std)
    if c.use_bias:
        blocks.update({"qkv_b": ((L, Q), "zeros"), "proj_b": ((L, D), "zeros"),
                       "fc1_b": ((L, F_), "zeros"),
                       "fc2_b": ((L, D), "zeros")})
        if c.gated_ffn:
            blocks["fcg_b"] = ((L, F_), "zeros")
    spec: Dict[str, Any] = {"wte": ((V, D), std), "blocks": blocks}
    if c.final_norm or c.embed_norm:
        spec["lnf_w"], spec["lnf_b"] = ((D,), "ones"), ((D,), "zeros")
    if not c.use_rope:
        spec["wpe"] = ((c.max_seq_len, D), std)
    if c.type_vocab_size > 0:
        spec["tte"] = ((c.type_vocab_size, D), std)
    if c.mlm_head:
        spec.update({"mlm_w": ((D, D), std), "mlm_b": ((D,), "zeros"),
                     "mlm_ln_w": ((D,), "ones"), "mlm_ln_b": ((D,), "zeros")})
    if not c.tie_word_embeddings:
        spec["lm_head"] = ((D, V), std)
    return spec


def init_params(config: GPTConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights with the reference's keys, shapes and stds (its numbers
    differ: the draws come from `generator`, which must live on `device`)."""
    device = resolve_device(device)

    def make(shape, init):
        if init == "ones":
            return torch.ones(shape, dtype=config.dtype, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=config.dtype, device=device)
        return torch.randn(shape, generator=generator, dtype=config.dtype,
                           device=device).mul_(init)

    def build(tree):
        return {k: build(v) if isinstance(v, dict) else make(*v)
                for k, v in tree.items()}

    return build(param_spec(config))


# ---------------------------------------------------------------------------
# dense trunk
# ---------------------------------------------------------------------------

def _norm(x, w, b, config):
    if config.use_rms_norm:
        return rms_norm_fused(x, w)
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + 1e-5)
    return (out * w + b).to(x.dtype)


def _act(config):
    if config.activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda h: F.gelu(h, approximate="tanh")
    return F.silu


def _inv_freq(config, device):
    D = config.head_dim
    return 1.0 / (10000.0 ** (torch.arange(0, D, 2, dtype=torch.float32,
                                           device=device) / D))


def _rope_tables(config, S, pos_offset=None, device=None):
    t = torch.arange(S, dtype=torch.float32, device=device)
    if pos_offset is not None:
        t = t + float(pos_offset)
    freqs = torch.outer(t, _inv_freq(config, device))
    return torch.sin(freqs), torch.cos(freqs)


def _rope_tables_at(config, pos):
    """pos [B, T] int -> sin/cos [B, T, head_dim/2] at explicit positions."""
    freqs = pos.float()[..., None] * _inv_freq(config, pos.device)
    return torch.sin(freqs), torch.cos(freqs)


def _layer(blocks, l):
    return {k: v[l] for k, v in blocks.items()}


def _block_qkv(bp, x, c: GPTConfig, pos_offset=None):
    """Pre-norm + packed qkv + rope, k/v repeated to H heads: the post-rope
    q, k, v [B, S, H, hd] that attention reads (the reference's
    `flash_qkv`)."""
    q, k, v = _prefill_qkv(bp, x, c, pos_offset=pos_offset)
    H, KVH = c.num_heads, c.kv_heads
    if KVH != H:
        k = torch.repeat_interleave(k, H // KVH, dim=2)
        v = torch.repeat_interleave(v, H // KVH, dim=2)
    return q, k, v


def _attend(q, k, v, c: GPTConfig, attn_impl=None):
    """[B, S, H, hd] attention: `attn_impl(q, k, v)` when given, else the
    differentiable flash kernels."""
    if attn_impl is not None:
        return attn_impl(q, k, v)
    return flash_attention_fused(q, k, v, causal=c.causal)


def block_forward(bp, x, config: GPTConfig, pos_offset=None, attn_impl=None):
    """One dense transformer block (no MoE); bp holds this block's unstacked
    weights.  attn_impl: optional callable (q, k, v) -> out overriding flash
    attention.  Returns the block output."""
    q, k, v = _block_qkv(bp, x, config, pos_offset)
    return _layer_tail(bp, x, _attend(q, k, v, config, attn_impl), config)


def run_blocks(blocks, x, config, pos_offset=None, remat=False,
               attn_impl=None):
    """The reference's `lax.scan` over stacked blocks, as a loop.  The
    stacked leaves are unbound once, so their gradients are stacked once.
    remat=True keeps, per block, what `remat_policy_save_attention` keeps:
    the block input, the post-rope q, k, v and attention's out and lse."""
    for ws in zip(*(w.unbind(0) for w in blocks.values())):
        bp = dict(zip(blocks, ws))
        if not remat:
            x = block_forward(bp, x, config, pos_offset, attn_impl)
            continue
        x = remat_policy_save_attention(
            functools.partial(_block_qkv, bp, c=config,
                              pos_offset=pos_offset),
            functools.partial(_attend, c=config, attn_impl=attn_impl),
            functools.partial(_layer_tail, bp, c=config), x)
    return x


def embed_prologue(params, x, config: GPTConfig, type_ids=None):
    """Learned positions, segment embeddings and embedding norm."""
    S = x.shape[1]
    if not config.use_rope:
        x = x + params["wpe"][:S]
    if config.type_vocab_size > 0:
        if type_ids is None:
            x = x + params["tte"][0]
        else:
            x = x + params["tte"][type_ids.long()]
    if config.embed_norm:
        x = _norm(x, params["lnf_w"], params["lnf_b"], config)
    return x


def epilogue(params, h, config: GPTConfig):
    """Final norm and/or the BERT MLM transform before the vocab head."""
    if config.final_norm:
        h = _norm(h, params["lnf_w"], params["lnf_b"], config)
    if config.mlm_head:
        h = torch.matmul(h, params["mlm_w"]) + params["mlm_b"]
        h = _act(config)(h)
        h = _norm(h, params["mlm_ln_w"], params["mlm_ln_b"], config)
    return h


def head_matrix(params, config: GPTConfig):
    if config.tie_word_embeddings:
        return params["wte"].T
    return params["lm_head"]


def backbone(params, tokens, config: GPTConfig, type_ids=None, remat=False,
             attn_impl=None):
    """tokens [B, S] -> (activations [B, S, D], head matrix)."""
    wte = params["wte"]
    x = wte[torch.as_tensor(tokens, device=wte.device).long()]
    x = embed_prologue(params, x, config, type_ids)
    x = run_blocks(params["blocks"], x, config, remat=remat,
                   attn_impl=attn_impl)
    return epilogue(params, x, config), head_matrix(params, config)


def forward(params, tokens, config: GPTConfig):
    """tokens [B, S] int -> logits [B, S, V], on the params' device."""
    x, head = backbone(params, tokens, config)
    return torch.matmul(x, head)


def _ce_sums(logits, labels):
    """(-sum log p[label], count) over valid labels (-100 = ignore)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    safe = torch.where(labels < 0, 0, labels)
    picked = torch.gather(lp, -1, safe[..., None])[..., 0]
    mask = (labels >= 0).float()
    return -(picked * mask).sum(), mask.sum()


def _chunk_ce(x, head, labels):
    return _ce_sums(torch.matmul(x, head), labels)


def loss_fn(params, tokens, labels, config: GPTConfig, remat=False,
            loss_chunk: Optional[int] = 512, attn_impl=None):
    """Causal LM loss (dense blocks); labels [B, S] with -100 = ignore.

    loss_chunk: when it divides S and is smaller, the LM head and
    log-softmax run per sequence chunk, each under a non-reentrant
    checkpoint, so the backward replays the chunk's head matmul and no
    [B, S, V] f32 log-probs are kept.  attn_impl overrides flash attention
    (e.g. a plain reference)."""
    x, head = backbone(params, tokens, config, remat=remat,
                       attn_impl=attn_impl)
    labels = torch.as_tensor(labels, device=x.device).long()
    S = x.shape[1]
    if not loss_chunk or S % loss_chunk != 0 or S <= loss_chunk:
        loss_sum, n = _ce_sums(torch.matmul(x, head), labels)
        return loss_sum / torch.clamp(n, min=1.0)
    loss_sum = n = 0.0
    for i in range(0, S, loss_chunk):
        part = slice(i, i + loss_chunk)
        ls, c = checkpoint(_chunk_ce, x[:, part], head, labels[:, part],
                           use_reentrant=False)
        loss_sum, n = loss_sum + ls, n + c
    return loss_sum / torch.clamp(n, min=1.0)


def count_params(params):
    return sum(count_params(v) if isinstance(v, dict) else v.numel()
               for v in params.values())


# ---------------------------------------------------------------------------
# serving trunk (mp=1, fp weights)
# ---------------------------------------------------------------------------

def _ffn_dense(bp, h, c: GPTConfig):
    up = torch.matmul(h, bp["fc1_w"])
    if "fc1_b" in bp:
        up = up + bp["fc1_b"]
    act = _act(c)
    if c.gated_ffn:
        gate = torch.matmul(h, bp["fcg_w"])
        if "fcg_b" in bp:
            gate = gate + bp["fcg_b"]
        h = act(gate) * up
    else:
        h = act(up)
    out = torch.matmul(h, bp["fc2_w"])
    if "fc2_b" in bp:
        out = out + bp["fc2_b"]
    return out


def _unpack_qkv(qkv, c: GPTConfig):
    """Split the packed `[q | k | v]` columns (the reference's parts=1
    layout; the per-partition one belongs to tensor-parallel serving)."""
    H, KVH, hd = c.num_heads, c.kv_heads, c.head_dim
    return torch.split(qkv, [H * hd, KVH * hd, KVH * hd], dim=-1)


def _prefill_qkv(bp, x, c: GPTConfig, pos=None, pos_offset=None):
    """Pre-norm + packed qkv + rope over [B, T, D] (positions pos_offset +
    0..T-1, or explicit per-slot positions `pos` [B, T]).  Returns post-rope
    q [B, T, H, hd], k, v [B, T, KVH, hd]."""
    B, T, _ = x.shape
    H, KVH, hd = c.num_heads, c.kv_heads, c.head_dim
    h = _norm(x, bp["ln1_w"], bp["ln1_b"], c) if c.norm_position == "pre" \
        else x
    qkv = torch.matmul(h, bp["qkv_w"])
    if "qkv_b" in bp:
        qkv = qkv + bp["qkv_b"]
    q, k, v = _unpack_qkv(qkv, c)
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, KVH, hd)
    v = v.reshape(B, T, KVH, hd)
    if c.use_rope:
        sin, cos = (_rope_tables(c, T, pos_offset, device=x.device)
                    if pos is None else _rope_tables_at(c, pos))
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def _decode_qkv(bp, x, c: GPTConfig, pos):
    """`_prefill_qkv` for one token a slot: x [B, D] at per-slot positions
    pos [B].  Returns post-rope q [B, H, hd], k, v [B, KVH, hd]."""
    q, k, v = _prefill_qkv(bp, x[:, None], c, pos=pos[:, None])
    return q[:, 0], k[:, 0], v[:, 0]


def _layer_tail(bp, x, attn, c: GPTConfig):
    """Out-proj + residual (+ post-LN) + FFN + residual (+ post-LN); attn
    is [B, T, D] or per head [B, T, H, hd]."""
    attn = torch.matmul(attn.reshape(x.shape), bp["proj_w"])
    if "proj_b" in bp:
        attn = attn + bp["proj_b"]
    x = x + attn
    if c.norm_position != "pre":
        x = _norm(x, bp["ln1_w"], bp["ln1_b"], c)
    h = _norm(x, bp["ln2_w"], bp["ln2_b"], c) if c.norm_position == "pre" \
        else x
    x = x + _ffn_dense(bp, h, c)
    if c.norm_position != "pre":
        x = _norm(x, bp["ln2_w"], bp["ln2_b"], c)
    return x


def _embed(params, tokens, config: GPTConfig, mesh=None):
    """Token-table lookup (mp=1, fp table)."""
    if mesh is not None:
        raise NotImplementedError("vocab-sharded embedding arrives with "
                                  "tensor-parallel serving")
    return params["wte"][tokens.long()]


def head_logits(x, params, config: GPTConfig, mesh=None):
    """Vocab projection `x @ head` (mp=1, fp head)."""
    if mesh is not None:
        raise NotImplementedError("vocab-sharded head arrives with "
                                  "tensor-parallel serving")
    return torch.matmul(x, head_matrix(params, config))


def sharded_argmax(logits, mesh=None):
    """First-occurrence argmax over the last axis (mp=1), as int32."""
    if mesh is not None:
        raise NotImplementedError("the sharded argmax merge arrives with "
                                  "tensor-parallel serving")
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _gumbel_pick(logits, noise, temperature, top_k):
    """The pick of `sample_token` given its Gumbel noise (same shape as
    logits): `argmax(top_k_mask(logits / temperature) + noise)`.  Pure, so
    tests can hand it the reference's noise."""
    lg = logits / temperature
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -1e30), lg)
    return torch.argmax(lg + noise.to(lg.dtype), dim=-1).to(torch.int32)


def gumbel_noise(shape, dtype, generator: torch.Generator, device):
    """Standard Gumbel noise drawn from `generator` (which lives on
    `device`): -log(-log(U)), U uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(dtype)


def sample_token(logits, generator, *, sample, temperature, top_k, mesh=None,
                 noise=None):
    """Greedy argmax or temperature/top-k sample over [B, V] logits, the
    categorical draw written as the Gumbel-argmax identity (as the
    reference).  Noise comes from `generator` unless given.  Returns ids [B]
    int32."""
    if not sample:
        return sharded_argmax(logits, mesh)
    if mesh is not None:
        raise NotImplementedError("sharded sampling arrives with "
                                  "tensor-parallel serving")
    if noise is None:
        noise = gumbel_noise(logits.shape, logits.dtype, generator,
                             logits.device)
    return _gumbel_pick(logits, noise, temperature, top_k)


# ---------------------------------------------------------------------------
# paged KV cache programs
# ---------------------------------------------------------------------------

def init_paged_cache(config: GPTConfig, num_pages: int, page_size: int,
                     device=None):
    """Per-layer paged KV pool {"k","v"} [L, num_pages, page_size, KVH, hd]
    in the model dtype (the int8 pool is a later slice); page 0 is the null
    page (inactive slots and padded rows write there)."""
    c = config
    shape = (c.num_layers, num_pages, page_size, c.kv_heads, c.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
            "v": torch.zeros(shape, dtype=c.dtype, device=device)}


def prefill_paged(params, input_ids, config: GPTConfig, cache, pages, length,
                  mesh=None):
    """Bucketed paged prefill: one dense causal pass over the bucket-padded
    prompt that writes KV into the slot's pages and returns logits at the
    last REAL position.  input_ids [B, Sb]; pages [B, Sb // page] page ids
    (entries past the reserved pages are the null page); length [B].
    Attention reads the full-precision k/v, GQA-repeated, not the pool.
    Returns (logits [B, V], cache) — the pool is written in place."""
    c = config
    assert c.causal, "KV-cache decoding requires a causal model"
    B, Sb = input_ids.shape
    H, KVH, hd = c.num_heads, c.kv_heads, c.head_dim
    page = cache["k"].shape[2]
    n_chunks = Sb // page
    pages = pages.long()
    x = _embed(params, input_ids, c, mesh=mesh)
    if not c.use_rope:
        x = x + params["wpe"][:Sb]
    for l in range(c.num_layers):
        bp = _layer(params["blocks"], l)
        q, k, v = _prefill_qkv(bp, x, c)
        # in-place page writes (the reference donates the pool and rebinds
        # the `.at[pages].set` result)
        cache["k"][l][pages] = k.reshape(B, n_chunks, page, KVH, hd)
        cache["v"][l][pages] = v.reshape(B, n_chunks, page, KVH, hd)
        if KVH != H:
            k = torch.repeat_interleave(k, H // KVH, dim=2)
            v = torch.repeat_interleave(v, H // KVH, dim=2)
        x = _layer_tail(bp, x, flash_attention_fused(q, k, v, causal=True), c)
    x = x[torch.arange(B, device=x.device), length.long() - 1]
    x = epilogue(params, x, c)
    return head_logits(x, params, c, mesh=mesh), cache


def decode_step_paged(params, tokens, cache, page_table, lengths,
                      config: GPTConfig, mesh=None):
    """Slot-indexed decode against the paged pool (the unfused engine's
    decode program).  tokens [B] int — the last emitted token per slot;
    page_table [B, max_pages] int32 (0 = null page); lengths [B] int32 —
    tokens already cached per slot.  Each layer writes the new token's k/v
    in place at page_table[b, lengths[b] // page][lengths[b] % page], then
    attends over lengths[b] + 1 positions.  Inactive slots (length 0,
    all-null row) compute garbage the scheduler ignores.  Returns
    (logits [B, V], cache)."""
    c = config
    assert c.causal, "KV-cache decoding requires a causal model"
    B = tokens.shape[0]
    page = cache["k"].shape[2]
    pos = lengths.long()
    x = _embed(params, tokens, c, mesh=mesh)                 # [B, D]
    if not c.use_rope:
        x = x + params["wpe"][pos.clamp(max=params["wpe"].shape[0] - 1)]
    pslot = (pos // page).clamp(max=page_table.shape[1] - 1)
    pidx = torch.gather(page_table.long(), 1, pslot[:, None])[:, 0]
    off = pos % page
    seen = (lengths + 1).to(torch.int32)
    for l in range(c.num_layers):
        bp = _layer(params["blocks"], l)
        q, k, v = _decode_qkv(bp, x, c, pos)
        cache["k"][l][pidx, off] = k        # in place (the reference donates)
        cache["v"][l][pidx, off] = v
        attn = paged_attention_decode(q, cache["k"][l], cache["v"][l],
                                      page_table, seen, mesh=mesh)
        x = _layer_tail(bp, x, attn, c)
    x = epilogue(params, x, c)
    return head_logits(x, params, c, mesh=mesh), cache


def _paged_chunk_hidden(params, input_ids, config: GPTConfig, cache,
                        page_table, q_offset, valid, attn_entry=None,
                        mesh=None):
    """Embed a [B, C] token chunk starting at per-slot position q_offset,
    write its KV token-granularly at page_table[(q_offset+t) // page]
    [(q_offset+t) % page] (padded rows t >= valid go to the null page 0),
    then attend through the page table.  Each layer writes its k/v BEFORE
    attending.  Returns (hidden [B, C, D] before the final norm, cache)."""
    attn_fn = attn_entry or paged_prefill_attention
    c = config
    assert c.causal, "KV-cache decoding requires a causal model"
    B, C = input_ids.shape
    D = c.hidden_size
    page = cache["k"].shape[2]
    ar = torch.arange(C, device=input_ids.device)
    pos = q_offset.long()[:, None] + ar                     # [B, C]
    real = ar[None, :] < valid.long()[:, None]
    x = _embed(params, input_ids, c, mesh=mesh)
    if not c.use_rope:
        # clamp like jnp.take: padded rows past wpe are never read
        x = x + params["wpe"][pos.clamp(max=params["wpe"].shape[0] - 1)]
    pslot = (pos // page).clamp(max=page_table.shape[1] - 1)
    pidx = torch.gather(page_table.long(), 1, pslot)
    pidx = torch.where(real, pidx, 0)                       # pad -> null page
    off = pos % page
    for l in range(c.num_layers):
        bp = _layer(params["blocks"], l)
        q, k, v = _prefill_qkv(bp, x, c, pos=pos)
        # token-granular in-place writes (the reference donates the pool)
        cache["k"][l][pidx, off] = k
        cache["v"][l][pidx, off] = v
        attn = attn_fn(q, cache["k"][l], cache["v"][l], page_table, q_offset,
                       valid, mesh=mesh)
        x = _layer_tail(bp, x, attn, c)
    return x, cache


def prefill_chunk_paged(params, input_ids, config: GPTConfig, cache,
                        page_table, q_offset, valid, mesh=None):
    """Chunked paged prefill (the unfused engine's chunk program): one pass
    over a [B, C] right-padded chunk starting at per-slot position q_offset,
    attending through the slot's FULL table row to everything below it.
    Returns (logits [B, V] at chunk index valid-1, cache)."""
    B = input_ids.shape[0]
    x, cache = _paged_chunk_hidden(params, input_ids, config, cache,
                                   page_table, q_offset, valid, mesh=mesh)
    x = x[torch.arange(B, device=x.device), valid.long() - 1]
    x = epilogue(params, x, config)
    return head_logits(x, params, config, mesh=mesh), cache


def serve_step_paged(params, tokens, cache, page_table, q_offset, valid,
                     config: GPTConfig, generator=None, greedy=None, *,
                     sample: bool = False, temperature=1.0, top_k=None,
                     mesh=None, noise=None):
    """The fused serving step: decode (valid 1), spec-verify (valid 1+K) and
    an interleaved prefill chunk (valid = chunk tokens) in one batch, with
    argmax, sampling and greedy acceptance on the device.

    Returns (out_tokens [B, T] int32, accept [B] int32, cache): out[b, t]
    is the greedy prediction after position t, except position valid-1 of
    a sampled slot (greedy[b] False), which carries the temperature/top-k
    pick; accept[b] is the greedy longest-prefix match over drafted tokens.
    The sampled lane's Gumbel noise [B, V] comes from `generator` unless
    `noise` is given."""
    x, cache = _paged_chunk_hidden(params, tokens, config, cache, page_table,
                                   q_offset, valid,
                                   attn_entry=paged_serve_attention, mesh=mesh)
    x = epilogue(params, x, config)
    logits = head_logits(x, params, config, mesh=mesh)      # [B, T, V]
    out = sharded_argmax(logits, mesh)                       # [B, T]
    B, T = tokens.shape
    rows = torch.arange(B, device=tokens.device)
    last = valid.long() - 1
    if sample:
        ids = sample_token(logits[rows, last], generator, sample=True,
                           temperature=temperature, top_k=top_k, mesh=mesh,
                           noise=noise)
        out[rows, last] = torch.where(greedy, out[rows, last], ids)
    match = (tokens[:, 1:] == out[:, :-1]) & \
        (torch.arange(T - 1, device=tokens.device)[None, :] < last[:, None])
    accept = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    return out, accept.to(torch.int32), cache
