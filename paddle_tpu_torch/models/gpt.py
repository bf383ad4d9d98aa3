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

Quantized serving, as the reference's: a params tree from
`quantization.quantize_serving_params` holds `name_q` (int8) +
`name_scale` (float32) for each serving matmul weight, which `_w`
dequantizes one layer at a time at its matmul (plain torch at the site, as
the reference computes it outside any kernel); the embedding gathers int8
rows and dequantizes them; the head multiplies the int8 table, upcast, and
scales the logits' columns.  An int8 pool (`init_paged_cache(...,
kv_dtype="int8")`) adds `k_scale`/`v_scale` `[L, P, page, KVH]` float32:
every pool write quantizes per token and kv head (`_quantize_kv`), and the
paged attention entries dequantize on read (`kv_scales=`).
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
from ..quantization.serving import (BLOCK_WEIGHT_KEYS, KV_SCALE_DTYPE,
                                    normalize_quant_dtype)


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

def param_spec(config: GPTConfig, weight_dtype=None) -> Dict[str, Any]:
    """The reference `init_params` tree as {key: (shape, init)}: init is a
    normal std (float), "ones" or "zeros".  One source for `init_params`
    and the shape check of `convert.params_from_numpy`.
    weight_dtype="int8" describes the tree `quantize_serving_params` makes
    of it: each quantized weight `name` becomes `name_q` and `name_scale`,
    whose init is the dtype they are stored in (int8, float32)."""
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
    if normalize_quant_dtype(weight_dtype, "weight_dtype") == "int8":
        spec = _quantized_spec(spec)
    return spec


def _quantized_spec(spec):
    """`param_spec` after weight-only int8 PTQ: scales [L, 1, out] for the
    block weights, [V, 1] for `wte` (per vocab row), [1, V] for `lm_head`
    (per vocab column)."""
    def pair(name, shape, scale_shape):
        return {name + "_q": (shape, torch.int8),
                name + "_scale": (scale_shape, torch.float32)}

    out: Dict[str, Any] = {}
    for name, leaf in spec.items():
        if name == "blocks":
            blocks: Dict[str, Any] = {}
            for k, (shape, init) in leaf.items():
                if k in BLOCK_WEIGHT_KEYS:
                    L, _, n = shape
                    blocks.update(pair(k, shape, (L, 1, n)))
                else:
                    blocks[k] = (shape, init)
            out["blocks"] = blocks
        elif name == "wte":
            out.update(pair(name, leaf[0], (leaf[0][0], 1)))
        elif name == "lm_head":
            out.update(pair(name, leaf[0], (1, leaf[0][1])))
        else:
            out[name] = leaf
    return out


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
    """The [D, V] vocab head (dequantized for an int8 tree)."""
    if config.tie_word_embeddings:
        if "wte_q" in params:
            return _deq(params["wte_q"], params["wte_scale"], config.dtype).T
        return params["wte"].T
    if "lm_head_q" in params:
        return _deq(params["lm_head_q"], params["lm_head_scale"],
                    config.dtype)
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
# serving trunk (mp=1; fp or weight-only int8)
# ---------------------------------------------------------------------------

def _deq(q, scale, dtype):
    """int8 values times their float32 scales, cast into the compute dtype:
    every weight dequant (blocks, embedding rows, head) is this one
    expression, as in the reference.  One kernel: the product is taken in
    float32 (the inputs' common dtype) and rounded once into the `dtype`
    output, the reference's `(q.astype(f32) * scale).astype(dtype)` without
    its float32 intermediate in memory."""
    return torch.mul(q, scale, out=torch.empty(q.shape, dtype=dtype,
                                               device=q.device))


def _w(bp, name, dtype):
    """Weight `name` of a (possibly weight-quantized) layer: `name_q` +
    `name_scale` dequantized at the matmul, so the full-precision copy of a
    quantized weight exists one layer at a time."""
    q = bp.get(name + "_q")
    if q is None:
        return bp[name]
    return _deq(q, bp[name + "_scale"], dtype)


def _ffn_dense(bp, h, c: GPTConfig):
    up = torch.matmul(h, _w(bp, "fc1_w", c.dtype))
    if "fc1_b" in bp:
        up = up + bp["fc1_b"]
    act = _act(c)
    if c.gated_ffn:
        gate = torch.matmul(h, _w(bp, "fcg_w", c.dtype))
        if "fcg_b" in bp:
            gate = gate + bp["fcg_b"]
        h = act(gate) * up
    else:
        h = act(up)
    out = torch.matmul(h, _w(bp, "fc2_w", c.dtype))
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
    qkv = torch.matmul(h, _w(bp, "qkv_w", c.dtype))
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
    attn = torch.matmul(attn.reshape(x.shape), _w(bp, "proj_w", c.dtype))
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
    """Token-table lookup (mp=1): an int8 table's rows are gathered with
    their scales and dequantized, so the fp table never exists."""
    if mesh is not None:
        raise NotImplementedError("vocab-sharded embedding arrives with "
                                  "tensor-parallel serving")
    t = tokens.long()
    if "wte_q" in params:
        return _deq(params["wte_q"][t], params["wte_scale"][t], config.dtype)
    return params["wte"][t]


def head_logits(x, params, config: GPTConfig, mesh=None):
    """Vocab projection `x @ head` (mp=1).  An int8 head enters the matmul
    upcast to the compute dtype (int8 values are exact there) and its
    per-vocab scales multiply the logits' columns afterwards, the same math
    since a scale is constant along the contraction; the transient is
    logits-shaped, not [V, D] dequantized."""
    if mesh is not None:
        raise NotImplementedError("vocab-sharded head arrives with "
                                  "tensor-parallel serving")
    if config.tie_word_embeddings and "wte_q" in params:
        return (torch.matmul(x, params["wte_q"].T.to(config.dtype)) *
                params["wte_scale"].T).to(config.dtype)
    if not config.tie_word_embeddings and "lm_head_q" in params:
        return (torch.matmul(x, params["lm_head_q"].to(config.dtype)) *
                params["lm_head_scale"]).to(config.dtype)
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
                     device=None, kv_dtype=None):
    """Per-layer paged KV pool {"k","v"} [L, num_pages, page_size, KVH, hd]
    in the model dtype; page 0 is the null page (inactive slots and padded
    rows write there).  kv_dtype="int8": int8 k/v plus float32 scale lanes
    `k_scale`/`v_scale` [L, num_pages, page_size, KVH], one a token and kv
    head (the reference's layout)."""
    c = config
    shape = (c.num_layers, num_pages, page_size, c.kv_heads, c.head_dim)
    device = resolve_device(device)
    if normalize_quant_dtype(kv_dtype, "kv_dtype") == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=KV_SCALE_DTYPE,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=KV_SCALE_DTYPE,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
            "v": torch.zeros(shape, dtype=c.dtype, device=device)}


def _quantize_kv(x):
    """Symmetric per-token, per-head int8 quantization of a KV write
    [..., hd] -> (int8 [..., hd], float32 scale [...]), the reference's
    math: absmax in float32, `max(absmax, 1e-30) / 127`, round half to
    even, clip to +-127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0) \
        .to(torch.int8)
    return q, scale


def _kv_scales(cache, l):
    """Layer l's (k_scale, v_scale) of an int8 pool; None for a float
    pool."""
    if "k_scale" in cache:
        return cache["k_scale"][l], cache["v_scale"][l]
    return None


def _write_kv(cache, l, idx, k, v):
    """Write k, v (the compute dtype) into layer l's pool at `idx` (an
    index tuple into [P, page]), in place; an int8 pool takes them
    quantized, with their scales."""
    if "k_scale" in cache:
        k, ks = _quantize_kv(k)
        v, vs = _quantize_kv(v)
        cache["k_scale"][l][idx] = ks
        cache["v_scale"][l][idx] = vs
    cache["k"][l][idx] = k
    cache["v"][l][idx] = v


def prefill_paged(params, input_ids, config: GPTConfig, cache, pages, length,
                  mesh=None):
    """Bucketed paged prefill: one dense causal pass over the bucket-padded
    prompt that writes KV into the slot's pages and returns logits at the
    last REAL position.  input_ids [B, Sb]; pages [B, Sb // page] page ids
    (entries past the reserved pages are the null page); length [B].
    Attention reads the full-precision k/v, GQA-repeated, not the pool: an
    int8 pool quantizes only the write, so the prompt's own logits see no
    KV quantization.  Returns (logits [B, V], cache) — the pool is written
    in place."""
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
        _write_kv(cache, l, (pages,), k.reshape(B, n_chunks, page, KVH, hd),
                  v.reshape(B, n_chunks, page, KVH, hd))
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
        _write_kv(cache, l, (pidx, off), k, v)  # in place (reference donates)
        attn = paged_attention_decode(q, cache["k"][l], cache["v"][l],
                                      page_table, seen, mesh=mesh,
                                      kv_scales=_kv_scales(cache, l))
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
        _write_kv(cache, l, (pidx, off), k, v)
        attn = attn_fn(q, cache["k"][l], cache["v"][l], page_table, q_offset,
                       valid, mesh=mesh, kv_scales=_kv_scales(cache, l))
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
