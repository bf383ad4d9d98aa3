"""Single-device trainer — port of `paddle_tpu/parallel/hybrid.py`.

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
from typing import Optional

import numpy as np
import torch

from ..models import gpt as gpt_mod

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
