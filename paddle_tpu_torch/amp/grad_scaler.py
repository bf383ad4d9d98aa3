"""GradScaler — port of `paddle_tpu/amp/grad_scaler.py` (reference:
`python/paddle/amp/grad_scaler.py:576`).

Dynamic loss scaling with found_inf tracking.  bf16 has float32's exponent
range, so with the default AMP dtype the scaling seldom matters; the
machinery is whole for float16 work all the same.

`unscale_` multiplies each grad by 1/scale in float32 and writes it back
into the grad in the grad's own dtype (no version bump), folding one
device flag of non-finite values across the parameters; the skip-or-step
decision reads that flag on the host once, the reference's contract.  Each
optimizer's unscale/inf status is kept apart in a `WeakKeyDictionary`.
"""
from __future__ import annotations

import weakref

import torch

from ..core.autograd import no_grad


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=65536.0, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._opt_states = weakref.WeakKeyDictionary()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def _opt_state(self, optimizer):
        # per-optimizer state (reference OptimizerState): a scaler may serve
        # several optimizers (e.g. GAN G/D) with independent unscale/inf
        # status; weak keys, so a dead optimizer pins no state
        return self._opt_states.setdefault(
            optimizer, {"unscaled": False, "found_inf": False})

    def unscale_(self, optimizer):
        if not self._enable:
            return
        state = self._opt_state(optimizer)
        if state["unscaled"]:
            # unscaling twice before step() would silently shrink the update
            raise RuntimeError(
                "unscale_() has already been called on this optimizer since "
                "the last step()")
        inv = 1.0 / self._scale
        # the inf/nan flag is folded on the device across the parameters and
        # read once at the end
        found_dev = None
        with torch.no_grad():
            for p in optimizer._parameter_list or []:
                if p.grad is None:
                    continue
                g = p.grad._t
                g32 = g.float() * inv
                bad = torch.isfinite(g32).all().logical_not()
                found_dev = bad if found_dev is None else found_dev | bad
                g.copy_(g32)
        # the skip/keep decision is a host branch: one read is the contract
        found = bool(found_dev) if found_dev is not None else False
        state["unscaled"] = True
        state["found_inf"] = found
        # update() adjusts the scale off the union of inf sightings this round
        self._found_inf = self._found_inf or found

    @no_grad()
    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        state = self._opt_state(optimizer)
        if not state["unscaled"]:
            self.unscale_(optimizer)
        if not state["found_inf"]:
            optimizer.step()
        state["unscaled"] = False
        state["found_inf"] = False

    def update(self):
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False  # fresh round of inf sightings

    def minimize(self, optimizer, loss):
        # the reference pattern is `scaled.backward(); scaler.minimize(opt,
        # scaled)`: reuse the existing .grad, running backward only if it
        # has not run on `loss` yet
        if loss._t.grad_fn is not None and \
                not getattr(loss, "_backward_ran", False):
            loss.backward()
        self.step(optimizer)
        self.update()

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)


AmpScaler = GradScaler
