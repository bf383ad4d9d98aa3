"""The trainer and the tensor-parallel serving layout — port of
`paddle_tpu/parallel/hybrid.py`.

Training: `HybridParallelTrainer(config, MeshConfig(dp=, sharding=, mp=,
sharding_stage=, sequence_parallel=, remat=), ...)`, then `train_step`
and `eval_loss`, called from one process.  A degree-1 mesh trains on one
device in that process.  Any other runs on a `parallel.tp` mesh of
dp x sharding x mp ranks (`mesh=`, or one the trainer starts on `devices=`):
rank r has the reference's coordinates, r = (d * sharding + s) * mp + m, so
it is device r of the reference's `build_mesh`.  Each rank keeps its own
`_RankTrainer` and gets one `ServingMesh.run` call a step; groups over the
"mp", "sharding", "dp" and data (dp x sharding) axes come from
`MeshRank.group`.

The layout is the reference's (`gpt_param_specs`, `_add_axis`,
`_resolve_spec`, `_opt_state_spec`): a spec is a tuple naming, per
dimension, the mesh axis it splits over, and each rank holds exactly the
shard that the reference's `NamedSharding` gives device r; the packed qkv
keeps each rank's heads in the per-partition column layout
(`qkv_partition_perm`), as serving does.  ZeRO's zero axis goes on the
first free dimension that divides, which for the stacked block leaves
`[L, ...]` is L whenever the degree divides it: a ZeRO-3 rank at rest
holds whole layers, and `_RankView.layers` gathers each layer's leaves
from their owner before the layer (a broadcast in the sharding group, or
an all-gather where the split fell on another dimension), drops them
after it, and gathers them again for the backward (saved-tensor hooks)
and for remat's replay (inside the checkpointed functions).

A step: the rank's batch rows (split over dp x sharding in the
reference's order) through `models.gpt.loss_fn(mesh=<the rank's view>)`
(Megatron blocks over `parallel.mp_ops`, vocab-parallel embedding and
cross entropy, the loss one global mean over the data group); the
gradients of the leaves that sequence parallelism leaves partial summed
over mp; stage 0-1 gradients all-reduced over the data group, stage 2-3
reduce-scattered to the owning shard; the clip's one global norm, each
element counted once; then the f32 AdamW of the single-device trainer on
the rank's shard, in slices of at most `_SLICE` elements, and under ZeRO
1-2 the updated parameter slices all-gathered over the zero group.

Serving: `serving_mesh` (defined in `parallel/tp.py`, re-exported here
where the reference keeps it), `serving_param_specs` (which axis of each
leaf splits over "mp"), `qkv_partition_perm` / `pack_qkv_partitions` (the
per-partition packed-qkv column layout) and `shard_params`, which cuts one
rank's shard out of the port's full tree (`models.convert`'s, or
`quantize_serving_params`' int8 one).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import weakref
from collections.abc import Mapping
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models import gpt as gpt_mod
from . import mp_ops
from .tp import (DEFAULT_TIMEOUT_S, ServingMesh, _tree_to,  # noqa: F401
                 serving_mesh)

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

    @property
    def size(self):
        return self.dp * self.pp * self.sharding * self.mp * self.ep * self.cp

    @property
    def zero_axis(self):
        """The axis the optimizer state shards over: "sharding" when it is
        there, else "dp" (pure-dp ZeRO-1), else None."""
        if self.sharding > 1:
            return "sharding"
        return "dp" if self.dp > 1 else None


# MeshConfig field -> the sub-item of ROADMAP Queue 1 "the rest of training"
_LATER = {"pp": "pp and vpp", "vpp": "pp and vpp", "ep": "MoE and ep",
          "cp": "cp"}


def _later(what, item):
    return NotImplementedError(
        f"{what} arrives with a later slice of the port (ROADMAP Queue 1: "
        f"the rest of training, {item})")


def check_supported(cfg: MeshConfig, config) -> None:
    """Raise for every setting the port's trainer does not take yet."""
    for field, item in _LATER.items():
        if getattr(cfg, field) != 1:
            raise _later(f"MeshConfig({field}={getattr(cfg, field)})", item)
    if cfg.sharding_stage not in (0, 1, 2, 3):
        raise ValueError(f"sharding_stage must be 0-3, got "
                         f"{cfg.sharding_stage}")
    for field in ("dp", "sharding", "mp"):
        if getattr(cfg, field) < 1:
            raise ValueError(f"MeshConfig.{field} must be >= 1")
    if config.moe_num_experts > 0 and (
            cfg.dp * cfg.sharding > 1 or cfg.sequence_parallel):
        # the reference sizes capacity and queue positions over the global
        # token count: a rank routing only its rows would drop others
        raise _later("MoE under data parallelism or sequence_parallel",
                     "MoE and ep")


def check_layout(config, cfg: MeshConfig) -> None:
    """ValueError where the model does not split over the mesh."""
    mp = cfg.mp
    if mp == 1:
        return
    for what, n in (("num_heads", config.num_heads),
                    ("kv_heads", config.kv_heads),
                    ("vocab_size", config.vocab_size)):
        if n % mp:
            raise ValueError(f"{what} ({n}) does not divide over mp={mp}")
    if config.moe_num_experts == 0 and config.ffn_size % mp:
        raise ValueError(f"ffn_size ({config.ffn_size}) does not divide "
                         f"over mp={mp}")
    if config.type_vocab_size or config.mlm_head or config.embed_norm:
        raise ValueError("the mp layouts cover the GPT family (no segment "
                         "embeddings, embedding norm or MLM head)")


# ---------------------------------------------------------------------------
# the parameter and optimizer-state layout
# ---------------------------------------------------------------------------

def gpt_param_specs(cfg: MeshConfig, model_config=None):
    """The Megatron layout (reference `gpt_param_specs` without its pp and
    ep axes): per leaf a tuple of the mesh axis each dimension splits over,
    None where it is whole.  qkv, fc1 and fcg column-split, proj and fc2
    row-split, `wte` vocab rows; under ZeRO-3 with sharding > 1 the block
    leaves are marked for the zero axis (`_add_axis_everywhere`), the
    embeddings left out."""
    mp = "mp" if cfg.mp > 1 else None
    use_bias = model_config is None or model_config.use_bias
    blocks = {"ln1_w": (None, None), "ln1_b": (None, None),
              "qkv_w": (None, None, mp), "proj_w": (None, mp, None),
              "ln2_w": (None, None), "ln2_b": (None, None)}
    if use_bias:
        blocks.update({"qkv_b": (None, mp), "proj_b": (None, None)})
    if model_config is not None and model_config.moe_num_experts > 0:
        blocks.update({"gate_w": (None, None, None),
                       "exp_fc1_w": (None, None, None, None),
                       "exp_fc1_b": (None, None, None),
                       "exp_fc2_w": (None, None, None, None),
                       "exp_fc2_b": (None, None, None)})
    else:
        blocks.update({"fc1_w": (None, None, mp), "fc2_w": (None, mp, None)})
        if use_bias:
            blocks.update({"fc1_b": (None, mp), "fc2_b": (None, None)})
        if model_config is not None and model_config.gated_ffn:
            blocks["fcg_w"] = (None, None, mp)
            if use_bias:
                blocks["fcg_b"] = (None, mp)
    specs = {"wte": (mp, None), "blocks": blocks, "lnf_w": (None,),
             "lnf_b": (None,)}
    if cfg.sharding_stage >= 3 and cfg.sharding > 1:
        specs["blocks"] = _add_axis_everywhere(blocks, "sharding")
    return specs


def _add_axis(spec, shape, axis_name: str, degree: int):
    """Shard `axis_name` onto the first unsharded, divisible dim of
    `shape`."""
    if axis_name in spec:
        return spec
    spec_l = list(spec) + [None] * (len(shape) - len(spec))
    for i, (s, cur) in enumerate(zip(shape, spec_l)):
        if cur is None and s % degree == 0 and s >= degree:
            spec_l[i] = axis_name
            break
    return tuple(spec_l)


def _add_axis_everywhere(specs, axis_name):
    """Mark specs for late binding: the dimension needs the shapes
    (`_resolve_spec`)."""
    return {k: ("__add__", axis_name, sp) for k, sp in specs.items()}


def _resolve_spec(marked, shape, cfg: MeshConfig):
    if len(marked) == 3 and marked[0] == "__add__":
        _, axis_name, sp = marked
        return _add_axis(sp, shape, axis_name, cfg.sharding)
    return tuple(marked) + (None,) * (len(shape) - len(marked))


def _opt_state_spec(param_spec, shape, cfg: MeshConfig):
    """ZeRO-1: the moments split over the zero axis on the first dim that
    is unsharded and divisible."""
    axis = cfg.zero_axis
    if cfg.sharding_stage < 1 or axis is None:
        return param_spec
    degree = cfg.sharding if axis == "sharding" else cfg.dp
    return _add_axis(param_spec, shape, axis, degree)


def trainer_specs(config, cfg: MeshConfig):
    """(param specs, moment specs), resolved against the config's shapes,
    as the reference trainer builds them (`wpe` replicated, an untied
    `lm_head` split by columns; leaves the layout does not name, such as
    BERT's, replicated)."""
    shapes = _map(lambda leaf: tuple(leaf[0]), gpt_mod.param_spec(config))
    marked = gpt_param_specs(cfg, config)
    mp = "mp" if cfg.mp > 1 else None
    marked["wpe"] = (None, None)
    marked["lm_head"] = (None, mp)

    def resolve(mk, sh):
        return {k: resolve(mk.get(k, {}), v) if isinstance(v, dict) else
                _resolve_spec(mk.get(k, ()), v, cfg) for k, v in sh.items()}

    pspecs = resolve(marked, shapes)
    mspecs = _map2(lambda sp, sh: _opt_state_spec(sp, sh, cfg), pspecs,
                   shapes)
    return pspecs, mspecs, shapes


def _leaves(tree):
    out = []
    for k in sorted(tree):
        out += _leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]]
    return out


def _names(tree, prefix=""):
    """The leaves' paths, in `_leaves` order."""
    out = []
    for k in sorted(tree):
        out += _names(tree[k], f"{prefix}{k}/") if isinstance(tree[k], dict) \
            else [prefix + k]
    return out


def _fill(tree, leaves):
    """`tree`'s structure with `leaves` in `_leaves` order."""
    it = iter(leaves)

    def walk(t):
        return {k: walk(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}
    return walk(tree)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _map2(fn, a, b):
    return {k: _map2(fn, v, b[k]) if isinstance(v, dict) else fn(v, b[k])
            for k, v in a.items()}


def coords(cfg: MeshConfig, r: int) -> Dict[str, int]:
    """Rank r's mesh coordinates: r = (dp * sharding + s) * mp + m."""
    return {"mp": r % cfg.mp, "sharding": (r // cfg.mp) % cfg.sharding,
            "dp": r // (cfg.mp * cfg.sharding)}


def _degree(cfg: MeshConfig, axis: str) -> int:
    return getattr(cfg, axis)


def _qkv_perm(name, spec, config, cfg):
    """The per-partition column order of an mp-split packed-qkv leaf."""
    if name.split("/")[-1] in ("qkv_w", "qkv_b") and spec[-1] == "mp":
        return torch.as_tensor(qkv_partition_perm(config, cfg.mp))
    return None


def cut_shard(t, spec, co, cfg: MeshConfig, perm=None):
    """Rank `co`'s shard of the full leaf `t` under `spec` (the packed
    qkv's columns first in the per-partition layout `perm`), a contiguous
    tensor of its own."""
    if perm is not None:
        t = t.index_select(-1, perm.to(t.device))
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = t.shape[dim] // _degree(cfg, axis)
            t = t.narrow(dim, co[axis] * n, n)
    return t.contiguous().clone()


def assemble(shards, spec, shape, cfg: MeshConfig, perm=None):
    """The full leaf from every rank's shard (rank order), in the
    reference layout (the qkv columns un-permuted)."""
    full = torch.empty(shape, dtype=shards[0].dtype)
    for r, s in enumerate(shards):
        co = coords(cfg, r)
        idx = tuple(slice(None) if a is None else
                    slice(co[a] * s.shape[d], (co[a] + 1) * s.shape[d])
                    for d, a in enumerate(spec))
        full[idx] = s
    if perm is not None:
        full = torch.empty_like(full).index_copy_(-1, perm, full)
    return full


# ---------------------------------------------------------------------------
# one rank of a training mesh
# ---------------------------------------------------------------------------

_Z3 = object()          # marks a packed ZeRO-3 layer leaf (saved-tensor hooks)


class _Z3Layer(Mapping):
    """One block's leaves under ZeRO-3: `[name]` gathers the leaf from its
    owner (through the autograd-aware gathers of `mp_ops`) at each use,
    and registers the result so that a saved copy of it is dropped and
    gathered again at the backward."""

    def __init__(self, view, l, unbound, anchors):
        self.view, self.l = view, l
        self.unbound, self.anchors = unbound, anchors

    def __iter__(self):
        return iter(self.unbound)

    def __len__(self):
        return len(self.unbound)

    def __contains__(self, k):          # without gathering the leaf
        return k in self.unbound

    def _src(self, k):
        kind = self.view.z3[k]
        if kind[0] == "bcast":
            per, shape = kind[1], kind[2]
            owner = self.l // per
            mine = self.view.groups["sharding"].rank == owner
            src = self.unbound[k][self.l - owner * per] if mine \
                else self.anchors[k]
            return src, owner, shape
        return self.unbound[k][self.l], kind[1], None

    def __getitem__(self, k):
        if k not in self.unbound:
            raise KeyError(k)
        if self.view.z3.get(k) is None:
            return self.unbound[k][self.l]
        g = self.view.groups["sharding"]
        src, a, shape = self._src(k)
        if shape is not None:
            out = mp_ops.broadcast_layer(src, g, a, shape,
                                         self.view.dtypes[k])
        else:
            out = mp_ops.gather_dim(src, g, a)
        self.view.remember(out, self, k)
        return out

    def raw(self, k):
        """The leaf gathered again, outside autograd."""
        g = self.view.groups["sharding"]
        src, a, shape = self._src(k)
        if shape is not None:
            return mp_ops.broadcast_raw(src, g, a, shape,
                                        self.view.dtypes[k])
        return g.all_gather(src.detach(), a)


class _RankView:
    """What the model functions see as `mesh=` on one training rank: the
    mp degree and coordinate, the device, the tensor- and
    sequence-parallel seams (`column_in`, `row_out`), the rank's rows of
    the sequence, the vocab-parallel cross entropy, the global mean over
    the data group, and under ZeRO-3 the layers gathered at each use."""

    def __init__(self, handle, cfg: MeshConfig, groups, co, num_layers):
        self.handle, self.groups = handle, groups
        self.num_layers = num_layers
        self.device = handle.device
        self.mp, self.rank = cfg.mp, co["mp"]
        self.sequence_parallel = cfg.sequence_parallel and cfg.mp > 1
        self.z3: Dict[str, Any] = {}        # block leaf -> how it gathers
        self.dtypes: Dict[str, torch.dtype] = {}
        self.anchors: Dict[str, torch.Tensor] = {}
        self._saved: Dict[int, Any] = {}

    def column_in(self, h):
        g = self.groups["mp"]
        return mp_ops.gather_from_sp(h, g) if self.sequence_parallel \
            else mp_ops.copy_to_mp(h, g)

    def row_out(self, y):
        g = self.groups["mp"]
        return mp_ops.scatter_to_sp(y, g) if self.sequence_parallel \
            else mp_ops.reduce_from_mp(y, g)

    def seq_rows(self, S: int):
        if not self.sequence_parallel:
            return None
        n = S // self.mp
        return slice(self.rank * n, (self.rank + 1) * n)

    def vocab_ce(self, logits, labels):
        return mp_ops.vocab_parallel_ce(logits, labels, self.groups["mp"],
                                        self.rank * logits.shape[-1])

    def global_mean(self, loss_sum, n):
        n = self.groups["data"].all_reduce(
            torch.as_tensor(n, dtype=torch.float32,
                            device=self.device).detach().clone())
        return loss_sum / torch.clamp(n, min=1.0)

    # ---- ZeRO-3 ----------------------------------------------------------
    def layers(self, blocks):
        if not self.z3:
            return gpt_mod._layers(blocks)
        unbound = {k: v.unbind(0) for k, v in blocks.items()}
        return (_Z3Layer(self, l, unbound, self.anchors)
                for l in range(self.num_layers))

    def remember(self, t, layer, k):
        ptr = t.untyped_storage().data_ptr()
        self._saved[ptr] = (layer, k)
        weakref.finalize(t, self._saved.pop, ptr, None)

    def _pack(self, t):
        try:
            hit = self._saved.get(t.untyped_storage().data_ptr())
        except (RuntimeError, NotImplementedError):
            hit = None
        if hit is None:
            return t
        return (_Z3, hit[0], hit[1], t.shape, t.stride(), t.storage_offset())

    @staticmethod
    def _unpack(x):
        if isinstance(x, tuple) and x[0] is _Z3:
            _, layer, k, shape, stride, offset = x
            return layer.raw(k).as_strided(shape, stride, offset)
        return x

    def saving(self):
        """Saved-tensor hooks that drop every gathered ZeRO-3 leaf autograd
        would keep, and gather it again when the backward reads it."""
        if not self.z3:
            return contextlib.nullcontext()
        return torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                        self._unpack)


def _groups(handle, cfg: MeshConfig, r: int):
    """Rank r's groups over the "mp", "sharding", "dp" and data axes, each
    in coordinate order (every rank asks for them in this order)."""
    mp, sh = cfg.mp, cfg.sharding
    co = coords(cfg, r)
    d, s, m = co["dp"], co["sharding"], co["mp"]
    rank = lambda d_, s_, m_: (d_ * sh + s_) * mp + m_  # noqa: E731
    members = {
        "mp": [rank(d, s, i) for i in range(mp)],
        "sharding": [rank(d, i, m) for i in range(sh)],
        "dp": [rank(i, s, m) for i in range(cfg.dp)],
        "data": [rank(i, j, m) for i in range(cfg.dp) for j in range(sh)]}
    return {name: handle.group(name, ranks) for name, ranks in members.items()}


class _RankTrainer:
    """One rank's parameter and moment shards and its step (the whole
    trainer on one device when `handle` is None).  It takes `params` as
    its own and updates them in place."""

    def __init__(self, config, cfg: MeshConfig, hyper, params, device,
                 handle=None, rank: int = 0):
        self.config, self.cfg = config, cfg
        self.device = device
        self.lr, self.wd, self.betas, self.clip_norm, self.moment_dtype = (
            hyper["lr"], hyper["wd"], hyper["betas"], hyper["clip"],
            hyper["moment_dtype"])
        self.params = _map(
            lambda p: p.detach().to(device).requires_grad_(), params)
        self.view = None
        self.zero_group = None
        self.last_gnorm = None
        self.layout: List[Dict[str, Any]] = [{} for _ in _leaves(params)]
        if handle is not None:
            self._mesh_layout(handle, rank)
        ms = [self._moment(p, lay) for p, lay in
              zip(_leaves(self.params), self.layout)]
        self.opt_state = {"m": _fill(self.params, ms),
                          "v": _fill(self.params,
                                     [torch.zeros_like(m) for m in ms]),
                          "step": 0}

    def _mesh_layout(self, handle, r):
        cfg = self.cfg
        co = coords(cfg, r)
        self.coords = co
        self.groups = _groups(handle, cfg, r)
        self.view = _RankView(handle, cfg, self.groups, co,
                              self.config.num_layers)
        pspecs, mspecs, _ = trainer_specs(self.config, cfg)
        zero = cfg.zero_axis
        for lay, name, p, ps, ms in zip(
                self.layout, _names(self.params), _leaves(self.params),
                _leaves(pspecs), _leaves(mspecs)):
            lay["mp_split"] = "mp" in ps
            lay["param_zero"] = zero is not None and zero in ps
            lay["zero_dim"] = ms.index(zero) if zero is not None and \
                zero in ms and not lay["param_zero"] else None
            if lay["param_zero"]:
                k = name.split("/")[-1]
                d = ps.index(zero)
                self.view.dtypes[k] = p.dtype
                if d == 0:
                    self.view.z3[k] = ("bcast", p.shape[0],
                                       tuple(p.shape[1:]))
                    self.view.anchors[k] = torch.empty(
                        0, dtype=p.dtype, device=self.device,
                        requires_grad=True)
                else:
                    self.view.z3[k] = ("dim", d - 1)
        self.zero_group = self.groups[zero] if zero is not None else None

    def _moment(self, p, lay):
        d = lay.get("zero_dim")
        shape = list(p.shape)
        if d is not None:
            shape[d] //= self.zero_group.size
        return torch.zeros(shape, dtype=self.moment_dtype, device=self.device)

    def _batch(self, a):
        return torch.as_tensor(np.asarray(a)).to(self.device).long()

    def loss_and_grads(self, tokens, labels):
        """The loss and its gradients, in `_leaves(self.params)` order.  On
        a mesh: the loss's global value, and the rank's gradient shards
        before any reduction."""
        leaves = _leaves(self.params)
        view = self.view
        anchors = list(view.anchors.values()) if view is not None else []
        with (view.saving() if view is not None
              else contextlib.nullcontext()):
            loss = gpt_mod.loss_fn(self.params, self._batch(tokens),
                                   self._batch(labels), self.config,
                                   remat=self.cfg.remat, mesh=view)
        # leaves the config never reads (RMSNorm's ln*_b) get zeros, as
        # under jax.grad, so weight decay still reaches them
        grads = torch.autograd.grad(loss, leaves + anchors, allow_unused=True,
                                    materialize_grads=True)[:len(leaves)]
        loss = loss.detach()
        if view is not None:
            loss = self.groups["data"].all_reduce(loss.clone())
        return loss, grads

    def train_step(self, tokens, labels):
        loss, grads = self.loss_and_grads(tokens, labels)
        self.apply_gradients(grads)
        return loss

    def eval_loss(self, tokens, labels):
        with torch.no_grad():
            loss = gpt_mod.loss_fn(self.params, self._batch(tokens),
                                   self._batch(labels), self.config,
                                   mesh=self.view)
            if self.view is not None:
                loss = self.groups["data"].all_reduce(loss.clone())
        return loss

    # ---- the update --------------------------------------------------------
    def _owned(self, grads):
        """Each leaf's gradient reduced over the mesh, as the slice of it
        this rank updates, and the slice's index (None: the whole shard).
        Stage 0-1: all-reduce over the data group; stage 2-3: reduce-scatter
        to the owner over the zero group (ZeRO-3 block leaves: summed over
        the sharding group by their gather's backward already)."""
        if self.view is None:
            return [(g, None) for g in grads]
        cfg, gr = self.cfg, self.groups
        out = []
        # the gradients are autograd's fresh tensors: reduced in place
        for g, lay in zip(grads, self.layout):
            g = g.contiguous()
            if self.view.sequence_parallel and not lay["mp_split"]:
                g = gr["mp"].all_reduce(g)      # partial over the rows
            d = lay["zero_dim"]
            if lay["param_zero"]:
                out.append((gr["dp"].all_reduce(g), None))
            elif d is None:
                out.append((gr["data"].all_reduce(g), None))
            elif cfg.sharding_stage >= 2:
                if cfg.zero_axis == "sharding":
                    g = gr["dp"].all_reduce(g)
                out.append((self.zero_group.reduce_scatter(g, d), d))
            else:
                g = gr["data"].all_reduce(g)
                n = g.shape[d] // self.zero_group.size
                out.append((g.narrow(d, self.zero_group.rank * n, n), d))
        return out

    def _counted(self, lay) -> bool:
        """Whether this rank counts its owned slice of a leaf in the global
        norm, so that every element of the gradient counts once."""
        if not lay["mp_split"] and self.coords["mp"] != 0:
            return False
        if lay["param_zero"] or lay["zero_dim"] is not None:
            return self.cfg.zero_axis == "dp" or self.coords["dp"] == 0
        return self.coords["dp"] == 0 and self.coords["sharding"] == 0

    @torch.no_grad()
    def apply_gradients(self, grads):
        """Global-norm clip, then the f32 AdamW update of the rank's shard,
        in place."""
        owned = self._owned(grads)
        leaves = _leaves(self.params)
        b1, b2 = self.betas
        lr, wd = self.lr, self.wd
        scale = None
        if self.clip_norm is not None:
            if self.view is None:
                gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                       for g, _ in owned))
            else:
                sq = sum(torch.sum(torch.square(g.float()))
                         for (g, _), lay in zip(owned, self.layout)
                         if self._counted(lay))
                sq = torch.as_tensor(sq, dtype=torch.float32,
                                     device=self.device).clone()
                gnorm = torch.sqrt(self.view.handle.all_reduce(sq))
            self.last_gnorm = gnorm
            scale = torch.clamp(
                self.clip_norm / torch.clamp(gnorm, min=self.clip_norm),
                max=1.0)
        self.opt_state["step"] += 1
        t = np.float32(self.opt_state["step"])
        b1p = 1.0 - float(np.float32(b1) ** t)    # f32, as the reference
        b2p = 1.0 - float(np.float32(b2) ** t)
        ms = _leaves(self.opt_state["m"])
        vs = _leaves(self.opt_state["v"])
        for p, (g, d), m, v in zip(leaves, owned, ms, vs):
            zg = self.zero_group
            part = p if d is None else p.narrow(
                d, zg.rank * (p.shape[d] // zg.size), p.shape[d] // zg.size)
            buf = part if part.is_contiguous() else part.contiguous()
            g = g.contiguous()
            for ps, gs, msl, vsl in zip(*(x.reshape(-1).split(_SLICE)
                                          for x in (buf, g, m, v))):
                g32 = gs.float() if scale is None else gs.float() * scale
                m32 = b1 * msl.float() + (1 - b1) * g32
                v32 = b2 * vsl.float() + (1 - b2) * g32 * g32
                u = (m32 / b1p) / (torch.sqrt(v32 / b2p) + 1e-8)
                ps.copy_(ps.float() * (1 - lr * wd) - lr * u)
                msl.copy_(m32)
                vsl.copy_(v32)
            if d is not None:
                p.copy_(zg.all_gather(buf, d))
            elif buf is not part:
                part.copy_(buf)

    def shapes(self):
        return {"params": _map(lambda t: tuple(t.shape), self.params),
                "m": _map(lambda t: tuple(t.shape), self.opt_state["m"])}

    def host_state(self):
        host = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        return {"params": _map(host, self.params),
                "m": _map(host, self.opt_state["m"]),
                "v": _map(host, self.opt_state["v"]),
                "step": self.opt_state["step"]}


_TIDS = itertools.count(1)       # trainer ids, unique in rank 0's process


def _rank_trainers(mesh) -> Dict[int, _RankTrainer]:
    """The trainers' states on this rank, by trainer id."""
    return mesh.state.setdefault("trainers", {})


def _rank_call(tid, what, args=(), drop=(), *, mesh):
    """Run `what` on this rank's trainer `tid` (`ServingMesh.run`'s
    function on every rank); `drop`: trainers that are gone."""
    trainers = _rank_trainers(mesh)
    for t in drop:
        trainers.pop(t, None)
    if what == "init":
        config, cfg, hyper, shard = args
        if mesh.rank:       # a private copy of what rank 0 sent
            shard = _tree_to(shard, mesh.device)
        trainers[tid] = _RankTrainer(config, cfg, hyper, shard, mesh.device,
                                     mesh, mesh.rank)
        return None
    rt = trainers[tid]
    if what == "step":
        return rt.train_step(*args)
    if what == "eval":
        return rt.eval_loss(*args)
    if what == "shapes":
        return rt.shapes()
    if what == "state":
        return rt.host_state()
    if what == "stats":
        mem = torch.cuda.max_memory_allocated(mesh.device) \
            if mesh.device.type == "cuda" else 0
        return {"comm": {k: list(v) for k, v in mesh.comm.items()},
                "peak_mem": mem}
    if what == "reset_stats":
        mesh.comm.clear()
        if mesh.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(mesh.device)
        return None
    if what == "close":
        trainers.pop(tid, None)
        return None
    raise ValueError(f"unknown trainer call {what!r}")


class HybridParallelTrainer:
    """Owns the params, the AdamW state and the train step: on one device
    for the degree-1 mesh (`device=None`: the CUDA card), else on a
    `parallel.tp` mesh of `mesh_cfg.size` ranks, `mesh=` (which it shares
    and leaves open) or one it starts on `devices` (None: one card a rank,
    NCCL; `["cuda:0"] * N` with `backend="gloo"`: several ranks on one
    card; `["cpu"] * N` on the CPU) and closes with itself.  `params`: a
    full tree in the reference layout (e.g. `convert.params_from_numpy`
    of the JAX `init_params`), which one device takes as its own and
    updates in place, and of which a mesh's rank 0 cuts every rank's shard
    (copies); otherwise `init_params` draws them from a generator seeded
    with `seed` on the first device.  `train_step` and
    `eval_loss` return the loss (rank 0's copy, a 0-d f32 tensor);
    `gathered_state()` is the counterpart of `np.asarray` of the
    reference's global arrays."""

    def __init__(self, config: gpt_mod.GPTConfig, mesh_cfg: MeshConfig,
                 learning_rate=1e-4, weight_decay=0.01, beta1=0.9,
                 beta2=0.95, grad_clip_norm: Optional[float] = 1.0, seed=0,
                 moment_dtype=torch.float32, device=None, params=None,
                 devices=None, mesh: Optional[ServingMesh] = None,
                 backend: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        check_supported(mesh_cfg, config)
        self.config = config
        self.cfg = mesh_cfg
        self.lr = learning_rate
        self.wd = weight_decay
        self.betas = (beta1, beta2)
        self.clip_norm = grad_clip_norm
        self.moment_dtype = moment_dtype
        hyper = {"lr": learning_rate, "wd": weight_decay,
                 "betas": (beta1, beta2), "clip": grad_clip_norm,
                 "moment_dtype": moment_dtype}
        size = mesh_cfg.size
        self.mesh = None
        if size == 1 and mesh is None:
            self.device = gpt_mod.resolve_device(
                devices[0] if devices is not None else device)
            if params is None:
                params = self._draw(seed)
            self._local = _RankTrainer(config, mesh_cfg, hyper, params,
                                       self.device)
            return
        if device is not None:
            raise ValueError(f"a mesh of {size} ranks runs on devices= or "
                             f"mesh=, not on one device ({device})")
        check_layout(config, mesh_cfg)
        own = mesh is None
        if own:
            mesh = serving_mesh(size, devices, backend, timeout_s)
        elif mesh.mp != size:
            raise ValueError(f"MeshConfig needs {size} ranks, the mesh has "
                             f"{mesh.mp}")
        self.mesh = mesh
        self.device = mesh.device
        self._tid = next(_TIDS)
        try:
            if params is None:
                params = self._draw(seed)
            pspecs, _, _ = trainer_specs(config, mesh_cfg)
            names, specs = _names(params), _leaves(pspecs)
            perms = [_qkv_perm(n, sp, config, mesh_cfg)
                     for n, sp in zip(names, specs)]

            def shard(r):
                co = coords(mesh_cfg, r)
                return _fill(params, [cut_shard(t, sp, co, mesh_cfg, pm)
                                      for t, sp, pm in
                                      zip(_leaves(params), specs, perms)])

            self._call("init", [(config, mesh_cfg, hyper, shard(r))
                                for r in range(size)])
        except BaseException:
            if own:
                mesh.close()
            raise
        self._finalizer = weakref.finalize(
            self, _close_trainer, weakref.ref(mesh), self._tid,
            mesh if own else None)

    def _draw(self, seed):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return gpt_mod.init_params(self.config, gen, self.device)

    def _call(self, what, per_rank_args=None):
        drops = self.mesh.state.pop("dropped_trainers", [])
        per = per_rank_args or [()] * self.mesh.mp
        return self.mesh.run(_rank_call, [((self._tid, what, a, drops), {})
                                          for a in per])

    def _batches(self, tokens, labels):
        """Each rank's batch rows: split over dp x sharding in the
        reference's order (data index d * sharding + s)."""
        cfg = self.cfg
        tok, lab = np.asarray(tokens), np.asarray(labels)
        data = cfg.dp * cfg.sharding
        B, S = tok.shape
        if B % data:
            raise ValueError(f"batch {B} does not divide over dp x sharding "
                             f"= {data}")
        if cfg.sequence_parallel and cfg.mp > 1 and S % cfg.mp:
            raise ValueError(f"sequence length {S} does not divide over "
                             f"mp={cfg.mp} under sequence_parallel")
        b = B // data
        out = []
        for r in range(self.mesh.mp):
            co = coords(cfg, r)
            i = co["dp"] * cfg.sharding + co["sharding"]
            out.append((tok[i * b:(i + 1) * b], lab[i * b:(i + 1) * b]))
        return out

    # ---- the step ----------------------------------------------------------
    def train_step(self, tokens, labels):
        """One step on tokens/labels [B, S]; returns the loss before the
        update (a 0-d f32 tensor on the first device)."""
        if self.mesh is None:
            return self._local.train_step(tokens, labels)
        return self._call("step", self._batches(tokens, labels))[0]

    def eval_loss(self, tokens, labels):
        if self.mesh is None:
            return self._local.eval_loss(tokens, labels)
        return self._call("eval", self._batches(tokens, labels))[0]

    def loss_and_grads(self, tokens, labels):
        """One device: the loss and its gradients in `_leaves` order."""
        return self._local.loss_and_grads(tokens, labels)

    def apply_gradients(self, grads):
        """One device: the clip and the AdamW update, in place."""
        self._local.apply_gradients(grads)

    def gnorm(self):
        """The global gradient norm of the last step's clip (rank 0's)."""
        return self._rank0.last_gnorm

    # ---- state -------------------------------------------------------------
    @property
    def _rank0(self) -> _RankTrainer:
        return self._local if self.mesh is None else \
            _rank_trainers(self.mesh)[self._tid]

    @property
    def params(self):
        """The params (on a mesh: rank 0's shard)."""
        return self._rank0.params

    @property
    def opt_state(self):
        """{"m", "v", "step"} (on a mesh: rank 0's shard)."""
        return self._rank0.opt_state

    def rank_shapes(self) -> List[Dict[str, Any]]:
        """Every rank's {"params", "m"} shard shapes."""
        if self.mesh is None:
            return [self._local.shapes()]
        return self._call("shapes")

    def gathered_state(self) -> Dict[str, Any]:
        """{"params", "m", "v", "step"}: the full trees on the CPU in the
        reference layout (the packed qkv columns un-permuted)."""
        if self.mesh is None:
            return self._local.host_state()
        states = self._call("state")
        pspecs, mspecs, shapes = trainer_specs(self.config, self.cfg)
        out = {"step": states[0]["step"]}
        names = _names(shapes)
        for key, specs in (("params", pspecs), ("m", mspecs),
                           ("v", mspecs)):
            full = [assemble([_leaves(s[key])[i] for s in states], sp, sh,
                             self.cfg, _qkv_perm(n, sp, self.config,
                                                 self.cfg))
                    for i, (n, sp, sh) in enumerate(zip(
                        names, _leaves(specs), _leaves(shapes)))]
            out[key] = _fill(shapes, full)
        return out

    def rank_stats(self) -> List[Dict[str, Any]]:
        """Every rank's collectives since `reset_rank_stats` ("group.op" ->
        [calls, bytes]) and its peak device bytes."""
        return self._call("stats")

    def reset_rank_stats(self) -> None:
        self._call("reset_stats")

    def close(self) -> None:
        """Free every rank's state (and the mesh, if the trainer started
        it)."""
        if self.mesh is not None and self._finalizer.alive:
            self._call("close")
            self._finalizer()


def _close_trainer(mesh_ref, tid, own_mesh):
    """A dropped trainer's rank states: gone with its own mesh, or dropped
    at the next trainer call on a shared one (a finalizer must not talk
    to the workers: it may run inside another call)."""
    if own_mesh is not None:
        own_mesh.close()
        return
    mesh = mesh_ref()
    if mesh is not None:
        mesh.state.setdefault("dropped_trainers", []).append(tid)


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
