"""RNG state.

Reference parity: `phi::Generator` (`paddle/phi/core/generator.h`) — per-device seeded
Philox state — and the fleet `RNGStatesTracker` (`fleet/layers/mpu/random.py`).
A `Generator` holds one `torch.Generator` per device (torch's CPU generator
is a Mersenne twister, its CUDA one Philox), each seeded with the
generator's seed when first drawn from, so that importing the package starts
no CUDA context.  The reference splits threefry keys instead; the port's
streams are its own, and its draws do not match the reference's numbers.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch


def _key(device) -> str:
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index
    return f"cuda:{torch.cuda.current_device() if index is None else index}"


class Generator:
    """Seeded, stateful RNG: one torch generator a device, made at its first
    draw."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens = {}
        self._lock = threading.Lock()

    def manual_seed(self, seed: int) -> "Generator":
        with self._lock:
            self._seed = int(seed)
            for g in self._gens.values():
                g.manual_seed(self._seed)
        return self

    seed = manual_seed

    def initial_seed(self) -> int:
        return self._seed

    def torch_generator(self, device) -> torch.Generator:
        """The torch generator that draws on `device` (made and seeded at
        the first call for that device)."""
        k = _key(device)
        with self._lock:
            g = self._gens.get(k)
            if g is None:
                g = torch.Generator(device=k).manual_seed(self._seed)
                self._gens[k] = g
            return g

    def get_state(self) -> dict:
        """A copy of the state: the seed and each drawn device's state.  A
        device not drawn from yet starts afresh from the seed."""
        with self._lock:
            return {"seed": self._seed,
                    "states": {k: g.get_state().clone()
                               for k, g in self._gens.items()}}

    def set_state(self, state: dict) -> None:
        with self._lock:
            self._seed = int(state["seed"])
            self._gens = {}
            for k, s in state["states"].items():
                g = torch.Generator(device=k)
                g.set_state(s.clone())
                self._gens[k] = g


_default = Generator(int(np.random.randint(0, 2**31 - 1)))


def default_generator() -> Generator:
    return _default


def seed(s: int) -> Generator:
    """paddle.seed — seeds the default generator and clears the tracker."""
    _default.manual_seed(s)
    _tracker.reset(s)
    return _default


class RNGStatesTracker:
    """Named parallel RNG states (fleet/layers/mpu/random.py parity).

    Model-parallel dropout needs different streams on different TP ranks for
    activation dropout but identical streams for weight init; named states
    provide both.  Inside `rng_state(name)` the default generator draws the
    named stream (its state is swapped in, and swapped back out at exit)."""

    def __init__(self):
        self._states = {}

    def reset(self, base_seed=None):
        self._states = {}

    def add(self, name: str, seed: int):
        if name in self._states:
            raise ValueError(f"rng state {name!r} already exists")
        self._states[name] = Generator(seed).get_state()

    def get_states_tracker(self) -> dict:
        """{name: state}, copies."""
        return {k: _copy_state(s) for k, s in self._states.items()}

    def set_states_tracker(self, states: dict):
        self._states = {k: _copy_state(s) for k, s in states.items()}

    @contextlib.contextmanager
    def rng_state(self, name: str = "global_seed"):
        if name == "global_seed" and name not in self._states:
            yield _default
            return
        if name not in self._states:
            raise ValueError(f"rng state {name!r} not added")
        outer = _default.get_state()
        _default.set_state(self._states[name])
        try:
            yield _default
        finally:
            self._states[name] = _default.get_state()
            _default.set_state(outer)


def _copy_state(state: dict) -> dict:
    return {"seed": state["seed"],
            "states": {k: s.clone() for k, s in state["states"].items()}}


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker
