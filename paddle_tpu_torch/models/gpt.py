"""GPT family on PyTorch — port of the functional core of
`paddle_tpu/models/gpt.py`: the GPT, Llama, MoE and BERT presets, the
trunk and loss, dense KV-cache generation and the paged serving programs.

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

An MoE config (`moe_num_experts > 0`) replaces every block's dense FFN by
capacity-routed experts (`gate_w` float32 `[L, D, E]`, `exp_fc{1,2}_{w,b}`
`[L, E, ...]`; `incubate.distributed.models.moe.dispatch`, plain torch as
the reference is plain jnp; on a training mesh `mesh.moe_ffn`, the
expert-parallel `parallel.moe`); the trunk returns the blocks'
load-balance loss beside its output, and `loss_fn` adds `moe_aux_weight`
times it.  `embed`, `run_blocks`, `epilogue` and `ce_sums` are the pieces
a pipeline stage (`parallel.pipeline`) runs of `loss_fn`.
`generate` runs the reference's dense-cache decoding (`init_cache`,
`prefill`, `decode_step`) as one program a shape key, its prefill and
decode step each a CUDA graph on the card.

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

Tensor-parallel serving (`mesh=`, a rank of `parallel.tp.ServingMesh`
with mp > 1): every serving function runs rank-locally over the rank's
shard (`parallel.hybrid.shard_params`): qkv, fc1 and fcg column-split
(the packed qkv in the per-partition layout `_unpack_qkv` reads), proj and
fc2 row-split, `wte` split by vocab rows and `lm_head` by vocab columns,
the pool holding KVH/mp heads of every page.  Head counts come from the
shard (`_heads`), never from a shrunken config (`head_dim` derives from
`num_heads`).  The row-parallel outputs are summed over the ranks and
their replicated biases added once after; the embedding is a masked local
take summed over the ranks; the logits stay vocab-sharded `[.., V/mp]` and
the picks merge (value, global index) pairs: MAX of the values, then MIN
of the index where the value is the max (`sharded_argmax`, `sample_token`).
The reference pins its activations' layouts for GSPMD with
`serving_mp_constraint`; an explicit rank-local computation has no layout
to pin, so that function has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from collections import OrderedDict
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..incubate.distributed.models.moe.dispatch import moe_ffn_dense
from ..incubate.kernels.flash_attention import (flash_attention_fused,
                                                flash_attention_mp,
                                                remat_policy_save_attention)
from ..incubate.kernels.paged_attention import (_check_mp_heads,
                                                _mp_degree,
                                                paged_attention_decode,
                                                paged_prefill_attention,
                                                paged_serve_attention,
                                                paged_verify_attention)
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
    # MoE: >0 replaces the dense FFN of every block with moe_num_experts
    # capacity-routed experts (expert-parallel degree 1)
    moe_num_experts: int = 0
    moe_topk: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

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


def gpt_moe_tiny(seq_len=128, num_experts=4, capacity_factor=2.0):
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                     max_seq_len=seq_len, moe_num_experts=num_experts,
                     moe_capacity_factor=capacity_factor)


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


def bert_config(vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12,
                max_seq_len=512, type_vocab_size=2, intermediate_size=None):
    """BERT: a bidirectional post-LN encoder with learned positions, segment
    embeddings, an embedding LayerNorm and the MLM transform before a head
    tied to the embeddings (no NSP head, as the reference)."""
    return GPTConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                     num_layers=num_layers, num_heads=num_heads,
                     max_seq_len=max_seq_len, use_rope=False, causal=False,
                     norm_position="post", embed_norm=True, final_norm=False,
                     type_vocab_size=type_vocab_size, mlm_head=True,
                     intermediate_size=intermediate_size)


def bert_base():
    return bert_config()


def bert_tiny(seq_len=128):
    return bert_config(vocab_size=256, hidden_size=64, num_layers=2,
                       num_heads=4, max_seq_len=seq_len)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_spec(config: GPTConfig, weight_dtype=None) -> Dict[str, Any]:
    """The reference `init_params` tree as {key: (shape, init[, dtype])}:
    init is a normal std (float), "ones" or "zeros"; the leaf takes the
    model dtype unless a third entry names its own (the MoE gate, float32
    as in the reference).  One source for `init_params` and the shape check
    of `convert.params_from_numpy`.
    weight_dtype="int8" describes the tree `quantize_serving_params` makes
    of it: each quantized weight `name` becomes `name_q` and `name_scale`,
    whose init is the dtype they are stored in (int8, float32); the MoE
    gate and expert banks pass through."""
    c = config
    D, L, F_, V, Q = (c.hidden_size, c.num_layers, c.ffn_size, c.vocab_size,
                      c.qkv_dim)
    std = c.initializer_range
    proj_std = std / math.sqrt(2 * L)
    blocks = {
        "ln1_w": ((L, D), "ones"), "ln1_b": ((L, D), "zeros"),
        "qkv_w": ((L, D, Q), std), "proj_w": ((L, D, D), proj_std),
        "ln2_w": ((L, D), "ones"), "ln2_b": ((L, D), "zeros"),
    }
    if c.use_bias:
        blocks.update({"qkv_b": ((L, Q), "zeros"), "proj_b": ((L, D), "zeros")})
    if c.moe_num_experts > 0:
        E = c.moe_num_experts
        blocks.update({"gate_w": ((L, D, E), std, torch.float32),
                       "exp_fc1_w": ((L, E, D, F_), std),
                       "exp_fc1_b": ((L, E, F_), "zeros"),
                       "exp_fc2_w": ((L, E, F_, D), proj_std),
                       "exp_fc2_b": ((L, E, D), "zeros")})
    else:
        blocks.update({"fc1_w": ((L, D, F_), std),
                       "fc2_w": ((L, F_, D), proj_std)})
        if c.gated_ffn:
            blocks["fcg_w"] = ((L, D, F_), std)
        if c.use_bias:
            blocks.update({"fc1_b": ((L, F_), "zeros"),
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


def leaf_dtype(leaf, config: GPTConfig):
    """The dtype a `param_spec` leaf is stored in."""
    if len(leaf) > 2:
        return leaf[2]
    return leaf[1] if isinstance(leaf[1], torch.dtype) else config.dtype


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
            for k, sub in leaf.items():
                if k in BLOCK_WEIGHT_KEYS:
                    L, _, n = sub[0]
                    blocks.update(pair(k, sub[0], (L, 1, n)))
                else:
                    blocks[k] = sub
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

    def make(leaf):
        shape, init = leaf[:2]
        dtype = leaf_dtype(leaf, config)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device).mul_(init)

    def build(tree):
        return {k: build(v) if isinstance(v, dict) else make(v)
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


def _block_qkv(bp, x, c: GPTConfig, pos_offset=None, mesh=None):
    """Pre-norm + packed qkv + rope, k/v repeated to H heads: the post-rope
    q, k, v [B, S, H, hd] that attention reads (the reference's
    `flash_qkv`); the rank's heads under a training `mesh`."""
    q, k, v = _prefill_qkv(bp, x, c, pos_offset=pos_offset, mesh=mesh)
    H, KVH = _heads(c, mesh)
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
    """One transformer block; bp holds this block's unstacked weights.
    attn_impl: optional callable (q, k, v) -> out overriding flash
    attention.  Returns (out, aux): aux is the block's MoE load-balance
    loss, a float32 0 when the block is dense."""
    q, k, v = _block_qkv(bp, x, config, pos_offset)
    x, aux = _block_tail(bp, x, _attend(q, k, v, config, attn_impl), config)
    return x, _zero_aux(x) if aux is None else aux


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _layers(blocks, mesh=None):
    """Each block's leaves: the stacked leaves unbound once, so their
    gradients are stacked once; a training `mesh` may hand out layers
    whose leaves it gathers at each use (ZeRO-3, `mesh.layers`)."""
    if mesh is not None and hasattr(mesh, "layers"):
        return mesh.layers(blocks)
    return (dict(zip(blocks, ws))
            for ws in zip(*(w.unbind(0) for w in blocks.values())))


def run_blocks(blocks, x, config, pos_offset=None, remat=False,
               attn_impl=None, mesh=None):
    """The reference's `lax.scan` over stacked blocks, as a loop.
    remat=True keeps, per block, what `remat_policy_save_attention` keeps:
    the block input, the post-rope q, k, v and attention's out and lse; the
    tail's checkpoint carries the MoE aux out.  Returns (out, aux), aux the
    MoE load-balance losses summed over the blocks (0 when dense).  Under
    a training `mesh` each block is the Megatron one over the rank's
    shard, on S/mp rows outside attention and the FFN body under sequence
    parallelism."""
    aux = _zero_aux(x)
    for bp in _layers(blocks, mesh):
        if not remat:
            q, k, v = _block_qkv(bp, x, config, pos_offset, mesh)
            x, a = _block_tail(bp, x, _attend(q, k, v, config, attn_impl),
                               config, mesh)
        else:
            x, a = remat_policy_save_attention(
                functools.partial(_block_qkv, bp, c=config,
                                  pos_offset=pos_offset, mesh=mesh),
                functools.partial(_attend, c=config, attn_impl=attn_impl),
                functools.partial(_block_tail, bp, c=config, mesh=mesh), x)
        if a is not None:
            aux = aux + a
    return x, aux


def embed_prologue(params, x, config: GPTConfig, type_ids=None, rows=None):
    """Learned positions, segment embeddings and embedding norm; `rows`:
    the positions x holds (default 0..S-1)."""
    if not config.use_rope:
        x = x + params["wpe"][slice(0, x.shape[1]) if rows is None else rows]
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
             attn_impl=None, mesh=None):
    """tokens [B, S] -> (activations [B, S, D], head matrix, MoE aux).
    Under a training `mesh` (a rank of `parallel.hybrid`'s trainer) the
    embedding is vocab-parallel, the activations are [B, S/mp, D] under
    sequence parallelism, and the head is the rank's vocab columns."""
    x = embed(params, tokens, config, type_ids, mesh)
    x, aux = run_blocks(params["blocks"], x, config, remat=remat,
                        attn_impl=attn_impl, mesh=mesh)
    return epilogue(params, x, config), head_matrix(params, config), aux


def embed(params, tokens, config: GPTConfig, type_ids=None, mesh=None):
    """tokens [B, S] -> the first block's input [B, S, D]: the token rows
    and `embed_prologue`; vocab-parallel, and the rank's S/mp rows under
    sequence parallelism, on a training `mesh`."""
    wte = params["wte"]
    tokens = torch.as_tensor(tokens, device=wte.device)
    rows = None
    if mesh is None:
        x = wte[tokens.long()]
    else:
        x = _embed(params, tokens, config, mesh)
        rows = mesh.seq_rows(tokens.shape[1])
    if type_ids is not None:
        type_ids = torch.as_tensor(type_ids, device=wte.device)
    return embed_prologue(params, x, config, type_ids, rows)


def forward(params, tokens, config: GPTConfig):
    """tokens [B, S] int -> logits [B, S, V], on the params' device."""
    x, head, _ = backbone(params, tokens, config)
    return torch.matmul(x, head)


def _ce_sums(logits, labels):
    """(-sum log p[label], count) over valid labels (-100 = ignore)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    safe = torch.where(labels < 0, 0, labels)
    picked = torch.gather(lp, -1, safe[..., None])[..., 0]
    mask = (labels >= 0).float()
    return -(picked * mask).sum(), mask.sum()


def _chunk_ce(x, head, labels, mesh=None):
    if _mp_degree(mesh) > 1:
        return mesh.vocab_ce(torch.matmul(x, head), labels)
    return _ce_sums(torch.matmul(x, head), labels)


def ce_sums(x, head, labels, loss_chunk: Optional[int] = 512, mesh=None):
    """(-sum log p[label], count of valid labels) of the activations x
    [B, S, D] after the epilogue under the head [D, V] (under a training
    `mesh`: vocab-parallel, x gathered from S/mp rows).  When loss_chunk
    divides S and is smaller, the head and log-softmax run per sequence
    chunk under a non-reentrant checkpoint, so the backward replays the
    chunk's head matmul and no [B, S, V] f32 log-probs are kept."""
    labels = torch.as_tensor(labels, device=x.device).long()
    if _mp_degree(mesh) > 1:
        x = mesh.column_in(x)
    ce = functools.partial(_chunk_ce, mesh=mesh)
    S = x.shape[1]
    if not loss_chunk or S % loss_chunk != 0 or S <= loss_chunk:
        return ce(x, head, labels)
    loss_sum = n = 0.0
    for i in range(0, S, loss_chunk):
        part = slice(i, i + loss_chunk)
        ls, c = checkpoint(ce, x[:, part], head, labels[:, part],
                           use_reentrant=False)
        loss_sum, n = loss_sum + ls, n + c
    return loss_sum, n


def loss_parts(params, tokens, labels, config: GPTConfig, remat=False,
               loss_chunk: Optional[int] = 512, attn_impl=None, mesh=None):
    """`loss_fn`'s two terms: (the mean cross entropy, the MoE penalty
    `moe_aux_weight` x the blocks' load-balance loss, None when dense).
    Under a training `mesh` both are the rank's terms (`loss_fn`)."""
    x, head, aux = backbone(params, tokens, config, remat=remat,
                            attn_impl=attn_impl, mesh=mesh)
    loss_sum, n = ce_sums(x, head, labels, loss_chunk, mesh)
    if mesh is not None:
        mean = mesh.global_mean(loss_sum, n)
    else:
        mean = loss_sum / torch.clamp(n, min=1.0)
    pen = config.moe_aux_weight * aux if config.moe_num_experts > 0 \
        else None
    return mean, pen


def loss_fn(params, tokens, labels, config: GPTConfig, remat=False,
            loss_chunk: Optional[int] = 512, attn_impl=None, mesh=None):
    """LM loss; labels [B, S] with -100 = ignore.  An MoE config adds
    `moe_aux_weight` times the blocks' load-balance loss.

    loss_chunk: see `ce_sums`.  attn_impl overrides flash attention (e.g.
    a plain reference).

    Under a training `mesh` tokens and labels are the rank's batch rows,
    the cross entropy is vocab-parallel (`mesh.vocab_ce`) over the full
    sequence, and the result is this rank's term of the one global mean:
    its loss sum over the valid labels of all the data-parallel ranks
    (`mesh.global_mean`), so that the ranks' gradients sum to the
    global loss's; the MoE penalty is the rank's term too
    (`mesh.moe_ffn`)."""
    mean, pen = loss_parts(params, tokens, labels, config, remat,
                           loss_chunk, attn_impl, mesh)
    return mean if pen is None else mean + pen


def count_params(params):
    return sum(count_params(v) if isinstance(v, dict) else v.numel()
               for v in params.values())


# ---------------------------------------------------------------------------
# serving trunk (fp or weight-only int8; tensor-parallel under mesh=)
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


def _heads(c: GPTConfig, mesh=None):
    """This rank's (query heads, kv heads): the config's over mp."""
    mp = _mp_degree(mesh)
    if mp > 1:
        _check_mp_heads(c.num_heads, c.kv_heads, mp)
    return c.num_heads // mp, c.kv_heads // mp


def _row_parallel(y, bp, bias, mesh):
    """A row-parallel matmul's partial sums reduced over the ranks (summed;
    reduce-scattered onto S/mp rows under sequence parallelism), then its
    replicated bias added once."""
    if _mp_degree(mesh) > 1:
        y = mesh.row_out(y)
    if bias in bp:
        y = y + bp[bias]
    return y


def _ffn_dense(bp, h, c: GPTConfig, mesh=None):
    """Dense FFN; under `mesh` fc1/fcg are the rank's columns and fc2 its
    rows, the output summed over the ranks."""
    if _mp_degree(mesh) > 1:
        h = mesh.column_in(h)
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
    return _row_parallel(torch.matmul(h, _w(bp, "fc2_w", c.dtype)), bp,
                         "fc2_b", mesh)


def _unpack_qkv(qkv, c: GPTConfig, parts: int = 1, heads=None):
    """Split packed qkv columns into flat q, k, v.  parts=1 reads the
    global `[q | k | v]` layout; parts=mp the per-partition
    `[q_0 k_0 v_0 | q_1 k_1 v_1 | ...]` one
    (`parallel.hybrid.pack_qkv_partitions`), giving q, k, v in global head
    order (reference `_unpack_qkv`).  `heads` = (H, KVH) of the columns
    given (default the config's): a rank's shard is one partition of its
    own heads."""
    H, KVH = heads or (c.num_heads, c.kv_heads)
    hd = c.head_dim
    if parts <= 1:
        return torch.split(qkv, [H * hd, KVH * hd, KVH * hd], dim=-1)
    lead = qkv.shape[:-1]
    Hl, KVHl = H // parts, KVH // parts
    g = qkv.reshape(*lead, parts, (Hl + 2 * KVHl) * hd)
    q = g[..., :Hl * hd].reshape(*lead, H * hd)
    k = g[..., Hl * hd:(Hl + KVHl) * hd].reshape(*lead, KVH * hd)
    v = g[..., (Hl + KVHl) * hd:].reshape(*lead, KVH * hd)
    return q, k, v


def _prefill_qkv(bp, x, c: GPTConfig, pos=None, pos_offset=None, mesh=None):
    """Pre-norm + packed qkv + rope over [B, T, D] (positions pos_offset +
    0..T-1, or explicit per-slot positions `pos` [B, T]).  Returns post-rope
    q [B, T, H, hd], k, v [B, T, KVH, hd], the rank's heads under
    `mesh` (whose `column_in` gathers a training rank's S/mp rows under
    sequence parallelism)."""
    H, KVH = _heads(c, mesh)
    hd = c.head_dim
    h = _norm(x, bp["ln1_w"], bp["ln1_b"], c) if c.norm_position == "pre" \
        else x
    if _mp_degree(mesh) > 1:
        h = mesh.column_in(h)
    B, T, _ = h.shape
    qkv = torch.matmul(h, _w(bp, "qkv_w", c.dtype))
    if "qkv_b" in bp:
        qkv = qkv + bp["qkv_b"]
    q, k, v = _unpack_qkv(qkv, c, heads=(H, KVH))
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, KVH, hd)
    v = v.reshape(B, T, KVH, hd)
    if c.use_rope:
        sin, cos = (_rope_tables(c, T, pos_offset, device=x.device)
                    if pos is None else _rope_tables_at(c, pos))
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def _decode_qkv(bp, x, c: GPTConfig, pos, mesh=None):
    """`_prefill_qkv` for one token a slot: x [B, D] at per-slot positions
    pos [B].  Returns post-rope q [B, H, hd], k, v [B, KVH, hd]."""
    q, k, v = _prefill_qkv(bp, x[:, None], c, pos=pos[:, None], mesh=mesh)
    return q[:, 0], k[:, 0], v[:, 0]


def _block_tail(bp, x, attn, c: GPTConfig, mesh=None):
    """Out-proj + residual (+ post-LN) + FFN or MoE + residual (+ post-LN);
    attn is [..., D] or per head [..., H, hd], x the block input.  Returns
    (x, aux): the MoE load-balance loss, None when dense.  Under `mesh`
    attn holds the rank's heads, proj and the FFN are row-parallel (summed
    over the ranks); an MoE FFN runs replicated, or a training rank's
    `mesh.moe_ffn` (expert- and data-parallel routing)."""
    # per head [.., H, hd] flattened; a training rank's attention holds S
    # rows where its x holds S/mp (sequence parallelism)
    attn = torch.matmul(attn.flatten(x.dim() - 1),
                        _w(bp, "proj_w", c.dtype))
    x = x + _row_parallel(attn, bp, "proj_b", mesh)
    if c.norm_position != "pre":
        x = _norm(x, bp["ln1_w"], bp["ln1_b"], c)
    h = _norm(x, bp["ln2_w"], bp["ln2_b"], c) if c.norm_position == "pre" \
        else x
    aux = None
    if c.moe_num_experts > 0 and hasattr(mesh, "moe_ffn"):
        y, aux = mesh.moe_ffn(bp, h, c)
    elif c.moe_num_experts > 0:
        y, aux = moe_ffn_dense(bp, h.reshape(-1, c.hidden_size), c)
        y = y.reshape(h.shape)
    else:
        y = _ffn_dense(bp, h, c, mesh)
    x = x + y
    if c.norm_position != "pre":
        x = _norm(x, bp["ln2_w"], bp["ln2_b"], c)
    return x, aux


def _layer_tail(bp, x, attn, c: GPTConfig, mesh=None):
    """`_block_tail` for the serving programs, which drop the aux (the
    reference's `_layer_tail`)."""
    return _block_tail(bp, x, attn, c, mesh)[0]


def _embed(params, tokens, config: GPTConfig, mesh=None):
    """Token-table lookup: an int8 table's rows are gathered with their
    scales and dequantized, so the fp table never exists.  Under `mesh` the
    table is the rank's vocab rows: each rank takes the rows it owns, zeros
    for the others, and the ranks' rows are summed (exactly one rank owns
    each id, so the sum is the replicated take, bit for bit): `mesh.row_out`,
    which a training rank reduce-scatters onto its S/mp rows under
    sequence parallelism."""
    quant = "wte_q" in params
    table = params["wte_q" if quant else "wte"]
    t = tokens.long()
    if _mp_degree(mesh) > 1:
        Vl = table.shape[0]
        t = t - mesh.rank * Vl
        ok = (t >= 0) & (t < Vl)
        t = t.clamp(0, Vl - 1)
    rows = _deq(table[t], params["wte_scale"][t], config.dtype) if quant \
        else table[t]
    if _mp_degree(mesh) <= 1:
        return rows
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    return mesh.row_out(rows)


def head_logits(x, params, config: GPTConfig, mesh=None):
    """Vocab projection `x @ head`.  An int8 head enters the matmul upcast
    to the compute dtype (int8 values are exact there) and its per-vocab
    scales multiply the logits' columns afterwards, the same math since a
    scale is constant along the contraction; the transient is
    logits-shaped, not [V, D] dequantized.  Under `mesh` the head is the
    rank's vocab shard and so are the logits, [.., V/mp]: the replicated
    [.., V] logits never exist (the picks merge them)."""
    if config.tie_word_embeddings and "wte_q" in params:
        return (torch.matmul(x, params["wte_q"].T.to(config.dtype)) *
                params["wte_scale"].T).to(config.dtype)
    if not config.tie_word_embeddings and "lm_head_q" in params:
        return (torch.matmul(x, params["lm_head_q"].to(config.dtype)) *
                params["lm_head_scale"]).to(config.dtype)
    return torch.matmul(x, head_matrix(params, config))


def _merge_pick(values, mesh):
    """The global first-occurrence argmax of vocab-sharded `values`
    [.., V/mp]: each rank's (max, global index of its first max), then the
    MAX of the maxima and the MIN of the indices where a rank holds it, V
    the sentinel."""
    Vl = values.shape[-1]
    li = torch.argmax(values, dim=-1, keepdim=True)
    lv = torch.gather(values, -1, li)[..., 0].to(torch.float32, copy=True)
    li = (li[..., 0] + mesh.rank * Vl).to(torch.int32)
    gm = mesh.all_reduce(lv.clone(), "max")
    cand = torch.where(lv == gm, li, torch.full_like(li, Vl * mesh.mp))
    return mesh.all_reduce(cand, "min")


def sharded_argmax(logits, mesh=None):
    """First-occurrence argmax over the vocab (last) axis, as int32.  Under
    `mesh` the logits are the rank's vocab shard and the ranks merge their
    (value, global index) pairs: the result is `torch.argmax` of the whole
    row on every rank, ties to the lowest index as there."""
    if _mp_degree(mesh) <= 1:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return _merge_pick(logits, mesh)


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


def _sharded_gumbel_pick(logits, noise, temperature, top_k, mesh):
    """`_gumbel_pick` over vocab-sharded logits [B, V/mp] and the rank's
    slice of the noise: the top-k threshold from every rank's local top-k
    (an all-gather written as a SUM over a zero-padded [B, mp * k] buffer),
    then the (value, global index) merge of `sharded_argmax`.  The same
    values meet the same comparisons as at mp=1, so the pick is the
    same."""
    lg = logits / temperature
    if top_k:
        k, Vl, r = int(top_k), lg.shape[-1], mesh.rank
        kl = min(k, Vl)
        buf = torch.zeros((*lg.shape[:-1], mesh.mp * k), dtype=torch.float32,
                          device=lg.device)
        buf[..., r * k:r * k + kl] = torch.topk(lg, kl, dim=-1).values
        buf[..., r * k + kl:(r + 1) * k] = -math.inf
        kth = torch.topk(mesh.all_reduce(buf, "sum"), k, dim=-1) \
            .values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -1e30), lg)
    return _merge_pick(lg + noise.to(lg.dtype), mesh)


def sample_token(logits, generator, *, sample, temperature, top_k, mesh=None,
                 noise=None):
    """Greedy argmax or temperature/top-k sample over [B, V] logits, the
    categorical draw written as the Gumbel-argmax identity (as the
    reference).  Noise comes from `generator` unless given.  Returns ids [B]
    int32.  Under `mesh` the logits are the rank's vocab shard [B, V/mp];
    the noise is drawn (or given) full-width [B, V] on every rank, the same
    on each, and each keeps its own columns (a given [B, V/mp] is taken as
    the rank's slice already), so the pick is the mp=1 pick."""
    if not sample:
        return sharded_argmax(logits, mesh)
    if _mp_degree(mesh) > 1:
        Vl = logits.shape[-1]
        if noise is None:
            noise = gumbel_noise((logits.shape[0], Vl * mesh.mp),
                                 logits.dtype, generator, logits.device)
        if noise.shape[-1] != Vl:
            noise = noise[..., mesh.vocab_slice(noise.shape[-1])]
        return _sharded_gumbel_pick(logits, noise, temperature, top_k, mesh)
    if noise is None:
        noise = gumbel_noise(logits.shape, logits.dtype, generator,
                             logits.device)
    return _gumbel_pick(logits, noise, temperature, top_k)


# ---------------------------------------------------------------------------
# dense KV-cache generation
# ---------------------------------------------------------------------------

def init_cache(config: GPTConfig, batch: int, max_len: int, device=None):
    """Dense per-layer KV cache {"k", "v"}: [L, batch, max_len, KVH, hd] in
    the model dtype (GQA caches the kv heads only)."""
    c = config
    shape = (c.num_layers, batch, max_len, c.kv_heads, c.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
            "v": torch.zeros(shape, dtype=c.dtype, device=device)}


def decode_step(params, token, cache, pos, config: GPTConfig):
    """One autoregressive step: token [B] at position `pos` (an int or a
    0-d integer tensor on the cache's device, the same for every row).
    Each layer writes the token's k/v into the cache in place, then attends
    to positions 0..pos through dense products in float32 with a position
    mask (the reference uses no kernel here: at one query row the GEMM is
    the fused path).  Returns (logits [B, V], cache)."""
    c = config
    assert c.causal, "KV-cache decoding requires a causal model"
    B = token.shape[0]
    D, H, KVH, hd = c.hidden_size, c.num_heads, c.kv_heads, c.head_dim
    G = H // KVH
    dev = cache["k"].device
    pos = torch.as_tensor(pos, device=dev).long().reshape(1)
    x = params["wte"][token.long()]                            # [B, D]
    if not c.use_rope:
        x = x + params["wpe"].index_select(0, pos)
    seen = torch.arange(cache["k"].shape[2], device=dev) <= pos
    rows = pos.expand(B)
    for l in range(c.num_layers):
        bp = _layer(params["blocks"], l)
        q, k, v = _decode_qkv(bp, x, c, rows)
        kc, vc = cache["k"][l], cache["v"][l]              # [B, S, KVH, hd]
        kc.index_copy_(1, pos, k[:, None])
        vc.index_copy_(1, pos, v[:, None])
        qg = q.reshape(B, KVH, G, hd)
        s = torch.einsum("bkgd,bskd->bkgs", qg.float(), kc.float()) \
            / math.sqrt(hd)
        p = torch.softmax(torch.where(seen, s, -1e30), dim=-1)
        attn = torch.einsum("bkgs,bskd->bkgd", p.to(vc.dtype), vc)
        x = _layer_tail(bp, x, attn.reshape(B, D), c)
    x = epilogue(params, x, c)
    return head_logits(x, params, c), cache


def prefill(params, input_ids, config: GPTConfig, cache):
    """One dense causal pass over the prompt [B, Tp] that fills cache
    positions [0, Tp) in place; attention is the flash kernel.  Returns
    (logits [B, V] at the last position, cache)."""
    c = config
    assert c.causal, "KV-cache decoding requires a causal model"
    ids = torch.as_tensor(input_ids, device=params["wte"].device).long()
    B, Tp = ids.shape
    H, KVH = c.num_heads, c.kv_heads
    x = params["wte"][ids]
    if not c.use_rope:
        x = x + params["wpe"][:Tp]
    for l in range(c.num_layers):
        bp = _layer(params["blocks"], l)
        q, k, v = _prefill_qkv(bp, x, c)
        cache["k"][l][:, :Tp] = k
        cache["v"][l][:, :Tp] = v
        if KVH != H:
            k = torch.repeat_interleave(k, H // KVH, dim=2)
            v = torch.repeat_interleave(v, H // KVH, dim=2)
        x = _layer_tail(bp, x, flash_attention_fused(q, k, v, causal=True), c)
    x = epilogue(params, x[:, -1], c)
    return head_logits(x, params, c), cache


def _leaf_tensors(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_tensors(tree[k])
        else:
            yield tree[k]


class _Generation:
    """`generate`'s program for one cache key: static buffers (prompt,
    token buffer, dense cache, position, EOS mask, temperature, the noise
    of every pick) and two bodies over them, the prefill (which also makes
    the first pick and resets the position) and one decode step (which
    advances it).  On the card each body is captured once as a CUDA graph
    and every call replays the prefill's, then the step's max_new - 1
    times; nothing reads a device value on the host.  A graph bakes in the
    parameters' addresses, which the cache key holds.  Eagerly (on the CPU,
    or with `capture=False`) the same bodies run over the same buffers."""

    def __init__(self, config, B, Tp, max_new, sample, top_k, eos, device,
                 capture):
        c = config
        self.config, self.Tp, self.max_new = c, Tp, max_new
        self.sample, self.top_k, self.eos = sample, top_k, eos
        self.device = device
        self.capture = capture and device.type == "cuda"
        self.ids = torch.zeros((B, Tp), dtype=torch.long, device=device)
        self.tokens = torch.zeros((B, Tp + max_new), dtype=torch.int32,
                                  device=device)
        self.cache = init_cache(c, B, Tp + max_new, device)
        self.pos = torch.zeros((1,), dtype=torch.long, device=device)
        self.finished = torch.zeros((B,), dtype=torch.bool, device=device)
        self.temp = torch.ones((), dtype=torch.float32, device=device)
        self.noise = torch.zeros((max_new, B, c.vocab_size), dtype=c.dtype,
                                 device=device) if sample else None
        self.graphs = None          # (prefill, step) and their launch deltas
        self.replays = 0

    def _pick(self, logits, i):
        if not self.sample:
            return sharded_argmax(logits)
        return _gumbel_pick(logits, self.noise.index_select(0, i)[0],
                            self.temp, self.top_k)

    def _after(self, nxt):
        if self.eos is not None:
            nxt = torch.where(self.finished, self.eos, nxt)
            self.finished |= nxt == self.eos
        return nxt

    def _prefill(self, params):
        Tp = self.Tp
        logits, _ = prefill(params, self.ids, self.config, self.cache)
        first = self._pick(logits, torch.zeros_like(self.pos))
        self.finished.zero_()
        self.tokens.zero_()
        self.tokens[:, :Tp] = self.ids
        self.tokens[:, Tp] = self._after(first)
        self.pos.fill_(Tp)

    def _step(self, params):
        tok = self.tokens.index_select(1, self.pos)[:, 0]
        logits, _ = decode_step(params, tok, self.cache, self.pos,
                                self.config)
        nxt = self._after(self._pick(logits, self.pos - (self.Tp - 1)))
        self.tokens.index_copy_(1, self.pos + 1, nxt[:, None])
        self.pos += 1

    def _build(self, params):
        from ..incubate import kernels as K
        from ..inference.graphs import GATE, capture
        with GATE.exclusive():
            before = K.counts()
            pool = torch.cuda.graph_pool_handle()
            graphs = [capture(lambda: self._prefill(params), self.device,
                              pool)]
            if self.max_new > 1:
                graphs.append(capture(lambda: self._step(params),
                                      self.device, pool))
            K.add_counts({k: before[k] - n for k, n in K.counts().items()})
        self.graphs = [(g, delta) for g, _, delta, _ in graphs]

    def __call__(self, params, input_ids, temperature, generator, noise):
        from ..incubate import kernels as K
        from ..inference.graphs import GATE
        self.ids.copy_(torch.as_tensor(input_ids))
        if self.sample:
            self.temp.fill_(temperature)
            if noise is None:
                noise = gumbel_noise(self.noise.shape, self.noise.dtype,
                                     generator, self.device)
            self.noise.copy_(torch.as_tensor(noise))
        if not self.capture:
            self._prefill(params)
            for _ in range(self.max_new - 1):
                self._step(params)
            return self.tokens.clone()
        if self.graphs is None:
            self._build(params)
        (prefill_graph, first), *rest = self.graphs
        with GATE.shared():
            prefill_graph.replay()
            K.add_counts(first)
            for graph, delta in rest * (self.max_new - 1):
                graph.replay()
                K.add_counts(delta)
            self.replays += 1 + len(rest) * (self.max_new - 1)
            return self.tokens.clone()


# LRU of `generate`'s programs, one a (config, B, Tp, max_new, sampling,
# top_k, eos, parameters, device) key; `compiles` counts the programs made,
# each captured on the card at its first call
GENERATE_CACHE_MAX = 16
_generate_cache: "OrderedDict[Any, _Generation]" = OrderedDict()
_generate_compiles = 0


def generate_cache_stats():
    """{'size', 'compiles', 'max_size', 'replays'}: programs held, made, the
    bound, and graph replays over the held programs."""
    return {"size": len(_generate_cache), "compiles": _generate_compiles,
            "max_size": GENERATE_CACHE_MAX,
            "replays": sum(p.replays for p in _generate_cache.values())}


def generate(params, input_ids, config: GPTConfig, max_new_tokens: int = 32,
             temperature: float = 0.0, top_k: Optional[int] = None,
             eos_token_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None, noise=None,
             _eager: bool = False):
    """Greedy or temperature/top-k sampling with a dense KV cache: one
    prefill pass, then max_new_tokens - 1 decode steps, each a graph replay
    on the card.  A sequence that emits eos_token_id stays at EOS.  Sampled
    picks draw their Gumbel noise from `generator` (default: seeded 0 on
    the params' device) unless `noise` [max_new_tokens, B, V] gives it.
    `_eager` runs the bodies without graphs (a comparison switch).

    input_ids [B, Tp] -> int32 [B, Tp + max_new_tokens] on the params'
    device."""
    global _generate_compiles
    B, Tp = input_ids.shape
    total = Tp + max_new_tokens
    if not config.use_rope and total > config.max_seq_len:
        raise ValueError(
            f"prompt {Tp} + max_new_tokens {max_new_tokens} exceeds "
            f"max_seq_len {config.max_seq_len} (learned positions)")
    sample = bool(temperature and temperature > 0.0)
    device = params["wte"].device
    key = (dataclasses.astuple(config), B, Tp, max_new_tokens, sample, top_k,
           eos_token_id, tuple(t.data_ptr() for t in _leaf_tensors(params)),
           device, _eager)
    prog = _generate_cache.get(key)
    if prog is not None:
        _generate_cache.move_to_end(key)            # LRU touch
    else:
        prog = _Generation(config, B, Tp, max_new_tokens, sample, top_k,
                           eos_token_id, device, capture=not _eager)
        _generate_compiles += 1
        _generate_cache[key] = prog
        while len(_generate_cache) > GENERATE_CACHE_MAX:
            _generate_cache.popitem(last=False)     # least recently used
    if sample and generator is None and noise is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return prog(params, input_ids, temperature if sample else 1.0,
                generator, noise)


# ---------------------------------------------------------------------------
# paged KV cache programs
# ---------------------------------------------------------------------------

def init_paged_cache(config: GPTConfig, num_pages: int, page_size: int,
                     device=None, kv_dtype=None, mp: int = 1):
    """Per-layer paged KV pool {"k","v"} [L, num_pages, page_size, KVH, hd]
    in the model dtype; page 0 is the null page (inactive slots and padded
    rows write there).  kv_dtype="int8": int8 k/v plus float32 scale lanes
    `k_scale`/`v_scale` [L, num_pages, page_size, KVH], one a token and kv
    head (the reference's layout).  mp > 1: one rank's shard, KVH/mp heads
    of every page (and of every scale lane)."""
    c = config
    if mp > 1:
        _check_mp_heads(c.num_heads, c.kv_heads, mp)
    shape = (c.num_layers, num_pages, page_size, c.kv_heads // mp,
             c.head_dim)
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
    KV quantization.  Under `mesh` each rank attends over its own heads
    (`flash_attention_mp`).  Returns (logits [B, V], cache) — the pool is
    written in place."""
    c = config
    assert c.causal, "KV-cache decoding requires a causal model"
    B, Sb = input_ids.shape
    H, KVH = _heads(c, mesh)
    hd = c.head_dim
    page = cache["k"].shape[2]
    n_chunks = Sb // page
    pages = pages.long()
    x = _embed(params, input_ids, c, mesh=mesh)
    if not c.use_rope:
        x = x + params["wpe"][:Sb]
    for l in range(c.num_layers):
        bp = _layer(params["blocks"], l)
        q, k, v = _prefill_qkv(bp, x, c, mesh=mesh)
        # in-place page writes (the reference donates the pool and rebinds
        # the `.at[pages].set` result)
        _write_kv(cache, l, (pages,), k.reshape(B, n_chunks, page, KVH, hd),
                  v.reshape(B, n_chunks, page, KVH, hd))
        if KVH != H:
            k = torch.repeat_interleave(k, H // KVH, dim=2)
            v = torch.repeat_interleave(v, H // KVH, dim=2)
        attn = flash_attention_fused(q, k, v, causal=True) if mesh is None \
            else flash_attention_mp(q, k, v, mesh, causal=True)
        x = _layer_tail(bp, x, attn, c, mesh)
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
        q, k, v = _decode_qkv(bp, x, c, pos, mesh)
        _write_kv(cache, l, (pidx, off), k, v)  # in place (reference donates)
        attn = paged_attention_decode(q, cache["k"][l], cache["v"][l],
                                      page_table, seen, mesh=mesh,
                                      kv_scales=_kv_scales(cache, l))
        x = _layer_tail(bp, x, attn, c, mesh)
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
        q, k, v = _prefill_qkv(bp, x, c, pos=pos, mesh=mesh)
        # token-granular in-place writes (the reference donates the pool)
        _write_kv(cache, l, (pidx, off), k, v)
        attn = attn_fn(q, cache["k"][l], cache["v"][l], page_table, q_offset,
                       valid, mesh=mesh, kv_scales=_kv_scales(cache, l))
        x = _layer_tail(bp, x, attn, c, mesh)
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


def verify_step_paged(params, tokens, cache, page_table, lengths, valid,
                      config: GPTConfig, mesh=None):
    """Speculative-decode verify (the unfused engine's verify program):
    score T = spec_len + 1 positions a slot in one pass.  tokens [B, T]:
    tokens[:, 0] is the slot's last emitted token, tokens[:, 1:] its draft;
    token t sits at position lengths[b] + t; valid [B] in [1, T] real
    tokens a slot (1: no draft).  Candidate KV is written into the slot's
    pages (rows t >= valid go to the null page); the caller rolls rejected
    positions back by not advancing lengths past the accepted prefix.  An
    int8 pool is read through its scale lanes, as in `prefill_chunk_paged`.
    Returns (logits [B, T, V] at every position, cache)."""
    x, cache = _paged_chunk_hidden(params, tokens, config, cache, page_table,
                                   lengths, valid,
                                   attn_entry=paged_verify_attention,
                                   mesh=mesh)
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
    `noise` is given (under `mesh`: see `sample_token`).  Under `mesh` every
    rank returns the same tokens."""
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


def swap_out_pages(cache, page_ids):
    """Preemption swap-out gather: the victim's pages copied out of the pool
    into a standalone buffer the host fetches later, so the pool pages can
    go to a new owner at once.  cache: every leaf [L, P, page, ...] (k and
    v, and the scale lanes [L, P, page, KVH] of an int8 pool); page_ids
    [max_pages] int32, the victim's pages padded with the null page 0, so
    one fixed-shape program serves every victim (the host drops the padding
    rows).  Returns {leaf: [L, max_pages, page, ...]}."""
    ids = page_ids.long()
    return {n: a.index_select(1, ids) for n, a in cache.items()}


def swap_in_pages(cache, page_ids, data):
    """Preemption swap-in scatter: restore a swapped victim's KV into its
    freshly allocated pages, in place, every leaf in one call (an int8
    pool's scale lanes with its pages).  page_ids is padded with the null
    page 0 as in `swap_out_pages`: the padding rows land on page 0, which
    inactive slots write anyway and nothing reads.  Returns the cache."""
    ids = page_ids.long()
    for n, a in cache.items():
        a.index_copy_(1, ids, data[n])
    return cache
