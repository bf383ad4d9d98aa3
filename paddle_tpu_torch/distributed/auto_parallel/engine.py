"""Auto-parallel Engine: fit/evaluate/predict over the hybrid trainer —
port of `paddle_tpu/distributed/auto_parallel/engine.py`.

The "distributed program" is a `parallel.HybridParallelTrainer` (one
device, or a `parallel.tp` mesh of dp x pp x sharding x mp x ep x cp
ranks); the Engine adds the mode loop, the loss history and checkpoints
with cross-mesh resharding: `save` writes the trainer's full trees
(`gathered_state`) in the reference's layout (`distributed.checkpoint`),
`load` cuts them for this engine's own mesh (`load_state`), which may
differ from the saving one, and takes checkpoints the JAX package's
Engine wrote.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...models import gpt as gpt_mod
from ...parallel.hybrid import (AXES, HybridParallelTrainer, MeshConfig,
                                _fill, _leaves, _map, _names, trainer_specs)
from .. import checkpoint as ckpt


class Engine:
    """fit/evaluate/predict over a model and its mesh.

    Either pass a ready `HybridParallelTrainer` as `model`, or a model
    `config` and a `mesh_config` (default one device) to build one, with
    `devices=` or `mesh=` and any other trainer keywords (`seed`,
    `params`, `moment_dtype`, ...).  `loss`, `optimizer`, `metrics` and
    `cluster` are accepted and unused, as in the reference; `strategy=`
    (fleet's `DistributedStrategy`) raises."""

    def __init__(self, model=None, loss=None, optimizer=None, metrics=None,
                 cluster=None, strategy=None, config=None, mesh_config=None,
                 devices=None, mesh=None, **trainer_kwargs):
        if strategy is not None:
            raise NotImplementedError(
                "Engine(strategy=) takes fleet's DistributedStrategy, which "
                "arrives with a later slice of the port (ROADMAP Queue 1 "
                "item 13: Paddle API breadth, eager distributed/ and "
                "fleet); pass mesh_config=")
        if model is not None and hasattr(model, "train_step"):
            self.trainer = model
        else:
            if config is None:
                raise ValueError("Engine needs a HybridParallelTrainer or a "
                                 "model config")
            self.trainer = HybridParallelTrainer(
                config, mesh_config or MeshConfig(), devices=devices,
                mesh=mesh, **trainer_kwargs)
        self._history = {"loss": []}

    # ---- data plumbing ----
    @staticmethod
    def _batches(data, batch_size):
        if isinstance(data, (tuple, list)) and len(data) == 2 \
                and hasattr(data[0], "shape"):  # (tokens, labels) array pair
            tokens, labels = np.asarray(data[0]), np.asarray(data[1])
            n = tokens.shape[0]
            bs = batch_size or n
            for i in range(0, n - bs + 1, bs):
                yield tokens[i:i + bs], labels[i:i + bs]
        else:  # iterable of (tokens, labels)
            for batch in data:
                yield np.asarray(batch[0]), np.asarray(batch[1])

    # ---- modes (ref engine.fit :454, evaluate :614, predict :701) ----
    def fit(self, train_data, epochs=1, batch_size=None, steps_per_epoch=None,
            log_freq=10, verbose=1, valid_data=None, **kwargs):
        for epoch in range(epochs):
            t0 = time.time()
            for step, (tok, lab) in enumerate(self._batches(train_data,
                                                            batch_size)):
                if steps_per_epoch is not None and step >= steps_per_epoch:
                    break
                loss = float(self.trainer.train_step(tok, lab))
                self._history["loss"].append(loss)
                if verbose and step % log_freq == 0:
                    print(f"[engine] epoch {epoch} step {step} "
                          f"loss {loss:.4f}", flush=True)
            if valid_data is not None and verbose:
                vl = self.evaluate(valid_data, batch_size, verbose=0)
                print(f"[engine] epoch {epoch} val_loss {vl:.4f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
        return self._history

    def evaluate(self, eval_data, batch_size=None, steps=None, verbose=1,
                 **kwargs):
        losses = []
        for step, (tok, lab) in enumerate(self._batches(eval_data, batch_size)):
            if steps is not None and step >= steps:
                break
            losses.append(float(self.trainer.eval_loss(tok, lab)))
        mean = float(np.mean(losses)) if losses else float("nan")
        if verbose:
            print(f"[engine] eval_loss {mean:.4f}", flush=True)
        return mean

    @torch.no_grad()
    def predict(self, test_data, batch_size=None, steps=None, verbose=0,
                **kwargs):
        """Logits [N, S, V] of the tokens (the tail batch included), on the
        CPU: `models.gpt.forward` on the trainer's first device, over its
        parameters (a mesh's gathered into the full tree first)."""
        tr = self.trainer
        if tr.mesh is None:
            params = tr.params
        else:
            params = _map(
                lambda t: t.to(tr.device),
                tr.gathered_state(("params",))["params"])
        data = test_data if isinstance(test_data, (tuple, list)) \
            else (test_data,)
        tokens = np.asarray(data[0])
        n = tokens.shape[0]
        bs = batch_size or n
        outs = []
        for i in range(0, n, bs):   # includes the tail remainder batch
            tok = torch.as_tensor(tokens[i:min(i + bs, n)],
                                  device=tr.device).long()
            outs.append(gpt_mod.forward(params, tok, tr.config).cpu())
        return torch.cat(outs, dim=0) if outs else None

    # ---- checkpoint with cross-mesh resharding ----
    def _layout(self):
        """The checkpoint's specs tree and mesh record: the reference's
        (`trainer_specs`; the step replicated, `[]`)."""
        tr = self.trainer
        pspecs, mspecs, _ = trainer_specs(tr.config, tr.cfg)
        specs = {"params": pspecs,
                 "opt": {"m": mspecs, "v": mspecs, "step": ()}}
        mesh = {"axes": list(AXES),
                "shape": [getattr(tr.cfg, a) for a in AXES]}
        return specs, mesh

    def save(self, path, training=True):
        """Write the full parameters (and, when `training`, the AdamW
        moments and step) to `path` (`distributed.checkpoint`)."""
        tr = self.trainer
        keys = ("params", "m", "v") if training else ("params",)
        full = tr.gathered_state(keys)
        state: Dict[str, Any] = {"params": full["params"]}
        if training:
            state["opt"] = {"m": full["m"], "v": full["v"],
                            "step": np.asarray(full["step"], np.int32)}
        specs, mesh = self._layout()
        ckpt.save_state_dict(state, path, specs, mesh)

    def load(self, path, strict=True, load_optimizer=True):
        """Reload onto THIS engine's mesh, which may differ from the mesh
        the checkpoint was saved on (ref converter.py cross-mesh resume).
        The optimizer section loads when present and `load_optimizer`.
        `strict`: the checkpoint's parameter leaves must be the model's;
        `strict=False` loads those it holds of the model's and keeps the
        others."""
        tr = self.trainer
        state = ckpt.load_state_dict(path)
        params = state["params"]
        opt: Optional[Dict[str, Any]] = state.get("opt") \
            if load_optimizer else None
        if not strict:
            keys = ("params", "m", "v") if opt is not None else ("params",)
            cur = tr.gathered_state(keys)
            params = _merged(cur["params"], params)
            if opt is not None:
                opt = {"m": _merged(cur["m"], opt["m"]),
                       "v": _merged(cur["v"], opt["v"]),
                       "step": opt.get("step", cur["step"])}
        if opt is None:
            tr.load_state(params)
        else:
            tr.load_state(params, opt["m"], opt["v"], int(opt["step"]))
        return self

    @property
    def history(self):
        return self._history


def _merged(current, loaded):
    """`current`'s tree with the leaves `loaded` holds at the same names."""
    flat = dict(zip(_names(loaded), _leaves(loaded)))
    names = _names(current)
    return _fill(current, [flat.get(n, t)
                           for n, t in zip(names, _leaves(current))])
