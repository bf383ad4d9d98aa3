"""Random ops (reference: `python/paddle/tensor/random.py`).

Every draw takes the default generator's torch generator for its device
(`core/generator.py`: Philox on the card, torch's Mersenne twister on the
CPU), so `paddle.seed` repeats it; a nonzero `seed=` argument draws from a
fresh generator seeded by it, apart from the global state.  The streams
are torch's, not the reference's threefry ones: the same seed gives other
numbers than the JAX package, from the same distributions.  Shapes and
dtypes follow the reference; integer draws are int64.
"""
from __future__ import annotations

import torch

from ..core import dtype as _dt
from ..core import generator as _gen
from ..core.place import expected_device
from ..core.tensor import Tensor, apply  # noqa: F401
from ._common import data as _to_data, shape as _shape


def _tdt(dtype):
    return _dt.to_torch(dtype if dtype is not None else _dt._default_dtype)


def _generator(device, seed=0):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return _gen.default_generator().torch_generator(device)


def _fill(x, draw):
    """The reference's `x._data = ...`: x's value replaced by `draw(t)`, a
    fresh draw into a float tensor like x's (float32 when x is not a
    floating tensor), in x's dtype."""
    t = x._t
    buf = torch.empty(t.shape, device=t.device,
                      dtype=t.dtype if t.is_floating_point() else torch.float32)
    return x._replace(draw(buf, _generator(t.device)))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = expected_device()
    out = torch.empty(_shape(shape), dtype=_tdt(dtype), device=dev)
    return Tensor._wrap(out.uniform_(min, max, generator=_generator(dev, seed)))


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def standard_normal(shape, dtype=None, name=None):
    dev = expected_device()
    return Tensor._wrap(torch.randn(_shape(shape), generator=_generator(dev),
                                    dtype=_tdt(dtype), device=dev))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        ref = mean if isinstance(mean, Tensor) else std
        dev = ref._t.device
        m = _to_data(mean, dev).detach()
        s = _to_data(std, dev).detach()
        out_shape = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(out_shape, generator=_generator(dev), dtype=torch.float32,
                        device=dev)
        return Tensor._wrap(m + s * z)
    dev = expected_device()
    z = torch.randn(_shape(shape or [1]), generator=_generator(dev),
                    dtype=_tdt(None), device=dev)
    return Tensor._wrap(mean + std * z)


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = expected_device()
    z = torch.randn(_shape(shape), generator=_generator(dev, seed),
                    dtype=_tdt(dtype), device=dev)
    return Tensor._wrap(mean + std * z)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = expected_device()
    td = _dt.to_torch(dtype) if dtype is not None else torch.int64
    return Tensor._wrap(torch.randint(low, high, _shape(shape),
                                      generator=_generator(dev), dtype=td,
                                      device=dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    data = _to_data(x)
    if high is None:
        low, high = 0, low
    td = _dt.to_torch(dtype) if dtype is not None else data.dtype
    draw = td if not (td.is_floating_point or td.is_complex or td == torch.bool) \
        else torch.int64
    out = torch.randint(low, high, data.shape, generator=_generator(data.device),
                        dtype=draw, device=data.device)
    return Tensor._wrap(out.to(td))


def randperm(n, dtype="int64", name=None):
    dev = expected_device()
    return Tensor._wrap(torch.randperm(int(n), generator=_generator(dev),
                                       device=dev).to(_dt.to_torch(dtype)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Draws of category indices from unnormalised probabilities along the
    last dim, int64."""
    data = _to_data(x).detach()
    flat = data.reshape(-1, data.shape[-1]).float()
    out = torch.multinomial(flat, num_samples, replacement,
                            generator=_generator(data.device))
    return Tensor._wrap(out.reshape(data.shape[:-1] + (num_samples,)))


def bernoulli(x, name=None):
    data = _to_data(x).detach()
    return Tensor._wrap(torch.bernoulli(data, generator=_generator(data.device)))


def bernoulli_(x, p=0.5, name=None):
    return _fill(x, lambda b, g: b.bernoulli_(p, generator=g))


def poisson(x, name=None):
    data = _to_data(x).detach()
    return Tensor._wrap(torch.poisson(data, generator=_generator(data.device)))


def binomial(count, prob, name=None):
    c = _to_data(count).detach()
    p = _to_data(prob, c.device).detach()
    c, p = torch.broadcast_tensors(c.float(), p.float())
    return Tensor._wrap(torch.binomial(c, p, generator=_generator(c.device))
                        .to(torch.int64))


def exponential_(x, lam=1.0, name=None):
    return _fill(x, lambda b, g: b.exponential_(lam, generator=g))


def cauchy_(x, loc=0, scale=1, name=None):
    return _fill(x, lambda b, g: b.cauchy_(loc, scale, generator=g))


def geometric_(x, probs, name=None):
    return _fill(x, lambda b, g: b.geometric_(probs, generator=g))


def log_normal_(x, mean=1.0, std=2.0, name=None):
    return _fill(x, lambda b, g: b.log_normal_(mean, std, generator=g))


def normal_(x, mean=0.0, std=1.0, name=None):
    return _fill(x, lambda b, g: b.normal_(mean, std, generator=g))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    t = x._t
    g = _generator(t.device, seed)
    return x._replace(torch.empty_like(t).uniform_(min, max, generator=g))


def rand_like(x, dtype=None, name=None):
    data = _to_data(x)
    td = _dt.to_torch(dtype) if dtype is not None else data.dtype
    return Tensor._wrap(torch.rand(data.shape, generator=_generator(data.device),
                                   dtype=td, device=data.device))


def randn_like(x, dtype=None, name=None):
    data = _to_data(x)
    td = _dt.to_torch(dtype) if dtype is not None else data.dtype
    return Tensor._wrap(torch.randn(data.shape, generator=_generator(data.device),
                                    dtype=td, device=data.device))


def get_rng_state():
    return [_gen.default_generator().get_state()]


def set_rng_state(state):
    _gen.default_generator().set_state(state[0] if isinstance(state, (list, tuple))
                                       else state)


def get_cuda_rng_state():
    return get_rng_state()


def set_cuda_rng_state(state):
    set_rng_state(state)

