"""Single-device trainer and the tensor-parallel serving layout — port of
`paddle_tpu/parallel/hybrid.py`.

Serving: `serving_mesh` (defined in `parallel/tp.py`, re-exported here
where the reference keeps it), `serving_param_specs` (which axis of each
leaf splits over "mp"), `qkv_partition_perm` / `pack_qkv_partitions` (the
per-partition packed-qkv column layout) and `shard_params`, which cuts one
rank's shard out of the port's full tree (`models.convert`'s, or
`quantize_serving_params`' int8 one).

`MeshConfig` keeps the reference's fields and defaults; the port takes the
degree-1 mesh only and raises `NotImplementedError` naming the ROADMAP
item for every other setting.  `HybridParallelTrainer.train_step` is the
reference's jitted `step` run eagerly: `loss_fn` and its gradients
(`remat` from the mesh config), the global-norm clip, then AdamW in f32
with bias correction, updating params and moments in place (the reference
donates and rebinds them), in slices of at most `_SLICE` elements so a
slice's f32 temporaries are the largest transient.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..models import gpt as gpt_mod
from .tp import ServingMesh, serving_mesh  # noqa: F401

_SLICE = 1 << 24


@dataclasses.dataclass
class MeshConfig:
    dp: int = 1
    pp: int = 1
    sharding: int = 1            # ZeRO axis degree
    mp: int = 1
    ep: int = 1                  # expert-parallel degree
    cp: int = 1                  # context-parallel degree (ring attention)
    vpp: int = 1                 # virtual pipeline chunks per stage
    sharding_stage: int = 1      # ZeRO stage: 1=opt state, 2=+grads, 3=+params
    micro_batches: int = 1       # pipeline microbatches (per global step)
    sequence_parallel: bool = False
    remat: bool = False


# MeshConfig degree -> the sub-item of ROADMAP Queue 1 "the rest of training"
_LATER = {"dp": "dp and ZeRO sharding", "sharding": "dp and ZeRO sharding",
          "mp": "mp and sequence parallelism", "pp": "pp and vpp",
          "vpp": "pp and vpp", "ep": "MoE and ep", "cp": "cp"}


def _later(what, item):
    return NotImplementedError(
        f"{what} arrives with a later slice of the port (ROADMAP Queue 1: "
        f"the rest of training, {item})")


def check_supported(cfg: MeshConfig) -> None:
    """Raise for every setting the single-device trainer does not take."""
    if cfg.sharding_stage > 1 and (cfg.dp > 1 or cfg.sharding > 1):
        raise _later(f"ZeRO stage {cfg.sharding_stage}",
                     "dp and ZeRO sharding")
    for field, item in _LATER.items():
        if getattr(cfg, field) != 1:
            raise _later(f"MeshConfig({field}={getattr(cfg, field)})", item)
    if cfg.sequence_parallel:
        raise _later("sequence_parallel=True", "mp and sequence parallelism")


def _leaves(tree):
    out = []
    for k in sorted(tree):
        out += _leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]]
    return out


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


class HybridParallelTrainer:
    """Owns the params, the AdamW state and the train step on one device
    (`device=None`: the CUDA card).  `params` takes the port's parameter
    dict (e.g. `convert.params_from_numpy`), which the trainer then owns
    and updates in place; otherwise `init_params` draws them from a
    generator seeded with `seed` on the device."""

    def __init__(self, config: gpt_mod.GPTConfig, mesh_cfg: MeshConfig,
                 learning_rate=1e-4, weight_decay=0.01, beta1=0.9,
                 beta2=0.95, grad_clip_norm: Optional[float] = 1.0, seed=0,
                 moment_dtype=torch.float32, device=None, params=None):
        check_supported(mesh_cfg)
        self.config = config
        self.cfg = mesh_cfg
        self.device = gpt_mod.resolve_device(device)
        self.lr = learning_rate
        self.wd = weight_decay
        self.betas = (beta1, beta2)
        self.clip_norm = grad_clip_norm
        self.moment_dtype = moment_dtype
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = gpt_mod.init_params(config, gen, self.device)
        self.params = _map(
            lambda p: p.detach().to(self.device).requires_grad_(), params)
        self.opt_state = {
            "m": _map(lambda p: torch.zeros_like(p, dtype=moment_dtype),
                      self.params),
            "v": _map(lambda p: torch.zeros_like(p, dtype=moment_dtype),
                      self.params),
            "step": 0}

    def _batch(self, a):
        return torch.as_tensor(a).to(self.device).long()

    def train_step(self, tokens, labels):
        """One step on tokens/labels [B, S]; returns the loss before the
        update (a 0-d f32 tensor on the device)."""
        loss, grads = self.loss_and_grads(tokens, labels)
        self.apply_gradients(grads)
        return loss

    def loss_and_grads(self, tokens, labels):
        """The loss and its gradients, in `_leaves(self.params)` order."""
        loss = gpt_mod.loss_fn(self.params, self._batch(tokens),
                               self._batch(labels), self.config,
                               remat=self.cfg.remat)
        # leaves the config never reads (RMSNorm's ln*_b) get zeros, as
        # under jax.grad, so weight decay still reaches them
        grads = torch.autograd.grad(loss, _leaves(self.params),
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), grads

    @torch.no_grad()
    def apply_gradients(self, grads):
        """Global-norm clip, then the f32 AdamW update, in place."""
        leaves = _leaves(self.params)
        b1, b2 = self.betas
        lr, wd = self.lr, self.wd
        scale = None
        if self.clip_norm is not None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads))
            scale = torch.clamp(
                self.clip_norm / torch.clamp(gnorm, min=self.clip_norm),
                max=1.0)
        self.opt_state["step"] += 1
        t = np.float32(self.opt_state["step"])
        b1p = 1.0 - float(np.float32(b1) ** t)    # f32, as the reference
        b2p = 1.0 - float(np.float32(b2) ** t)
        ms = _leaves(self.opt_state["m"])
        vs = _leaves(self.opt_state["v"])
        for p, g, m, v in zip(leaves, grads, ms, vs):
            for ps, gs, msl, vsl in zip(*(x.reshape(-1).split(_SLICE)
                                          for x in (p, g, m, v))):
                g32 = gs.float() if scale is None else gs.float() * scale
                m32 = b1 * msl.float() + (1 - b1) * g32
                v32 = b2 * vsl.float() + (1 - b2) * g32 * g32
                u = (m32 / b1p) / (torch.sqrt(v32 / b2p) + 1e-8)
                ps.copy_(ps.float() * (1 - lr * wd) - lr * u)
                msl.copy_(m32)
                vsl.copy_(v32)

    def eval_loss(self, tokens, labels):
        with torch.no_grad():
            return gpt_mod.loss_fn(self.params, self._batch(tokens),
                                   self._batch(labels), self.config)


# ---------------------------------------------------------------------------
# tensor-parallel serving layout
# ---------------------------------------------------------------------------

# the Megatron block layout (reference `gpt_param_specs` with mp on, pp and
# ep off): the axis of each [L, ...] block leaf that splits over "mp"
_COLUMN = ("qkv_w", "fc1_w", "fcg_w")          # [L, D, out]: split out
_ROW = ("proj_w", "fc2_w")                      # [L, in, D]: split in
_COLUMN_BIAS = ("qkv_b", "fc1_b", "fcg_b")      # [L, out]
_VOCAB = {"wte": 0, "wte_q": 0, "wte_scale": 0,            # [V, D], [V, 1]
          "lm_head": 1, "lm_head_q": 1, "lm_head_scale": 1}  # [D, V], [1, V]


def _block_axis(k: str) -> Optional[int]:
    if k.endswith("_q"):
        k = k[:-2]
    elif k.endswith("_scale"):
        # [L, 1, out]: splits with a column-parallel weight's outputs, stays
        # whole for a row-parallel one
        return 2 if k[:-len("_scale")] in _COLUMN else None
    if k in _COLUMN:
        return 2
    if k in _ROW:
        return 1
    if k in _COLUMN_BIAS:
        return 1
    return None     # norms, row-parallel biases, the MoE gate and experts


def serving_param_specs(model_config, params) -> Dict[str, object]:
    """The tree of `params` with, for each leaf, the axis that splits over
    "mp" under tensor-parallel serving, or None where the leaf is
    replicated (reference `serving_param_specs`, its PartitionSpecs read as
    the one "mp" axis each names).  qkv, fc1 and fcg are column-split and
    proj and fc2 row-split; `wte` splits by rows and `lm_head` by columns;
    an int8 leaf keeps its weight's split and its scale splits with its
    channel; norms, `wpe`, the row-parallel biases and the MoE gate and
    experts are replicated."""
    blocks = {k: _block_axis(k) for k in params["blocks"]}
    specs = {k: _VOCAB.get(k) for k in params if k != "blocks"}
    specs["blocks"] = blocks
    return specs


def qkv_partition_perm(model_config, parts: int) -> np.ndarray:
    """The column permutation from the packed `[q | k | v]` qkv layout to
    the per-partition `[q_0 k_0 v_0 | q_1 k_1 v_1 | ...]` one, whose `parts`
    contiguous column groups are each rank's head slices (reference
    `qkv_partition_perm`)."""
    H, KVH, hd = (model_config.num_heads, model_config.kv_heads,
                  model_config.head_dim)
    assert H % parts == 0 and KVH % parts == 0, (H, KVH, parts)
    q = np.arange(H * hd).reshape(parts, -1)
    k = H * hd + np.arange(KVH * hd).reshape(parts, -1)
    v = (H + KVH) * hd + np.arange(KVH * hd).reshape(parts, -1)
    return np.concatenate([q, k, v], axis=1).reshape(-1)


_QKV_LEAVES = ("qkv_w", "qkv_b", "qkv_w_q", "qkv_w_scale")


def pack_qkv_partitions(params, model_config, parts: int):
    """Every packed-qkv leaf (weight, bias, int8 twin and its scale) with
    its columns in the per-partition layout (`qkv_partition_perm`);
    `parts <= 1` is the identity (reference `pack_qkv_partitions`)."""
    if parts <= 1:
        return params
    blocks = dict(params["blocks"])
    for k in _QKV_LEAVES:
        if k in blocks:
            perm = torch.as_tensor(qkv_partition_perm(model_config, parts),
                                   device=blocks[k].device)
            blocks[k] = blocks[k].index_select(-1, perm)
    return dict(params, blocks=blocks)


def shard_params(params, config, mp: int, rank: int):
    """Rank `rank`'s shard of the full serving tree `params` under
    `serving_param_specs`, the packed qkv in the per-partition layout
    (`pack_qkv_partitions`, then a contiguous split), every leaf a
    contiguous tensor of its own on the leaf's device: a split leaf is a
    copy, a replicated one the same tensor."""
    if mp <= 1:
        return params
    specs = serving_param_specs(config, params)

    def cut(name, t, axis, perm=None):
        if axis is None:
            return t
        n = t.shape[axis]
        if n % mp:
            raise ValueError(f"{name}: axis {axis} of {tuple(t.shape)} does "
                             f"not split over mp={mp}")
        part = n // mp
        if perm is not None:
            idx = torch.as_tensor(perm.reshape(mp, part)[rank],
                                  device=t.device)
            return t.index_select(axis, idx)
        return t.narrow(axis, rank * part, part).contiguous()

    perm = qkv_partition_perm(config, mp)
    blocks = {k: cut(k, v, specs["blocks"][k],
                     perm if k in _QKV_LEAVES and specs["blocks"][k] is not
                     None else None)
              for k, v in params["blocks"].items()}
    out = {k: cut(k, v, specs[k]) for k, v in params.items() if k != "blocks"}
    out["blocks"] = blocks
    return out
