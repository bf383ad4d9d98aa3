"""The trainer and the tensor-parallel serving layout — port of
`paddle_tpu/parallel/hybrid.py`.

Training: `HybridParallelTrainer(config, MeshConfig(dp=, pp=, sharding=,
mp=, ep=, vpp=, micro_batches=, sharding_stage=, sequence_parallel=,
remat=), ...)`, then `train_step`, `eval_loss` and `gathered_state()`,
called from one process.  A degree-1 mesh trains on one device in that
process.  Any other runs on a `parallel.tp` mesh of dp x pp x sharding x
mp x ep ranks (`mesh=`, or one the trainer starts on `devices=`): rank r
has the reference's coordinates (`coords`, `build_mesh`'s order), r =
((((d * pp + p) * sharding + s) * mp + m) * ep + e) * cp + c, so it is
device r of the reference's mesh.  Each rank keeps its own `_RankTrainer`
and gets one `ServingMesh.run` call a step; its groups (`_groups`) come
from `MeshRank.group`.  `cp` is the one axis still refused.

The layout is the reference's (`gpt_param_specs`, `_add_axis`,
`_resolve_spec`, `_opt_state_spec`): a spec is a tuple naming, per
dimension, the mesh axis it splits over, and each rank holds the shard
that the reference's `NamedSharding` gives device r: block leaves split
their layers over "pp", the experts over "ep", and the packed qkv keeps
each rank's heads in the per-partition column layout
(`qkv_partition_perm`), as serving does.  Under vpp a stage holds its own
interleaved chunks (`stage_layers`), where the reference holds contiguous
layers and re-slices them every step: the shard shapes are the
reference's, rank r's contents are not device r's, and `gathered_state`
puts each layer back in its place.  ZeRO's zero axis goes on the first
free dimension that divides: for the stacked block leaves `[L, ...]`
that is L whenever pp does not take it and the degree divides it, and a
ZeRO-3 rank at rest then holds whole layers, which `_RankView.layers`
gathers from their owner before each layer (a broadcast in the sharding
group; an all-gather where the split fell on another dimension, as under
pp), drops after it, and gathers again for the backward (saved-tensor
hooks) and for remat's replay (inside the checkpointed functions).

A step: the rank's batch rows (split over dp x sharding x ep in the
reference's order, `data_index`; under pp each of the `micro_batches`
contiguous microbatches split so) through `models.gpt.loss_parts(mesh=
<the rank's view>)` (Megatron blocks over `parallel.mp_ops`,
vocab-parallel embedding and cross entropy, the loss one global mean over
the data group; MoE blocks through `parallel.moe` over the rank's routing
group and its ep peers), or under pp through the stages
(`parallel.pipeline`); the gradients of the leaves that sequence
parallelism leaves partial summed over mp; each leaf's gradient summed
over its group (dense leaves over dp x sharding x ep, expert leaves over
dp x sharding, and the leaves every stage holds over pp too): stage 0-1
all-reduced, stage 2-3 reduce-scattered to the owning shard; the clip's
one global norm, each element counted once; then the f32 AdamW of the
single-device trainer on the rank's shard, in slices of at most `_SLICE`
elements, and under ZeRO 1-2 the updated parameter slices all-gathered
over the zero group.

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

from ..incubate.distributed.models.moe.dispatch import log_routes
from ..models import gpt as gpt_mod
from . import mp_ops, pipeline
from .moe import EXPERT_KEYS, moe_local
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
_LATER = {"cp": "cp"}


def _later(what, item):
    return NotImplementedError(
        f"{what} arrives with a later slice of the port (ROADMAP Queue 1: "
        f"the rest of training, {item})")


def check_supported(cfg: MeshConfig, config) -> None:
    """Raise for every setting the port's trainer does not take yet, and
    for a degree below 1."""
    for field, item in _LATER.items():
        if getattr(cfg, field) != 1:
            raise _later(f"MeshConfig({field}={getattr(cfg, field)})", item)
    if cfg.sharding_stage not in (0, 1, 2, 3):
        raise ValueError(f"sharding_stage must be 0-3, got "
                         f"{cfg.sharding_stage}")
    for field in ("dp", "pp", "sharding", "mp", "ep", "vpp",
                  "micro_batches"):
        if getattr(cfg, field) < 1:
            raise ValueError(f"MeshConfig.{field} must be >= 1")
    # the reference's AssertionErrors, raised whatever python's -O
    if cfg.vpp > 1 and cfg.pp == 1:
        raise AssertionError(
            "vpp (interleaved virtual stages) requires pp > 1 (ref: "
            "virtual_pp_degree needs pipeline parallelism)")


def check_layout(config, cfg: MeshConfig) -> None:
    """ValueError where the model does not split over the mesh."""
    if config.num_layers % cfg.pp:
        raise ValueError(f"num_layers ({config.num_layers}) does not divide "
                         f"over pp={cfg.pp}")
    if cfg.ep > 1 and config.moe_num_experts % cfg.ep:
        raise ValueError(f"moe_num_experts ({config.moe_num_experts}) does "
                         f"not divide over ep={cfg.ep}")
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
    """The Megatron layout (reference `gpt_param_specs`): per leaf a tuple
    of the mesh axis each dimension splits over, None where it is whole.
    Block leaves split their layers over "pp"; qkv, fc1 and fcg
    column-split, proj and fc2 row-split, `wte` vocab rows; the experts
    split over "ep" (`gate_w` replicated); under ZeRO-3 with sharding > 1
    the block leaves are marked for the zero axis
    (`_add_axis_everywhere`), the embeddings left out."""
    pp = "pp" if cfg.pp > 1 else None
    mp = "mp" if cfg.mp > 1 else None
    ep = "ep" if cfg.ep > 1 else None
    use_bias = model_config is None or model_config.use_bias
    blocks = {"ln1_w": (pp, None), "ln1_b": (pp, None),
              "qkv_w": (pp, None, mp), "proj_w": (pp, mp, None),
              "ln2_w": (pp, None), "ln2_b": (pp, None)}
    if use_bias:
        blocks.update({"qkv_b": (pp, mp), "proj_b": (pp, None)})
    if model_config is not None and model_config.moe_num_experts > 0:
        blocks.update({"gate_w": (pp, None, None),
                       "exp_fc1_w": (pp, ep, None, None),
                       "exp_fc1_b": (pp, ep, None),
                       "exp_fc2_w": (pp, ep, None, None),
                       "exp_fc2_b": (pp, ep, None)})
    else:
        blocks.update({"fc1_w": (pp, None, mp), "fc2_w": (pp, mp, None)})
        if use_bias:
            blocks.update({"fc1_b": (pp, mp), "fc2_b": (pp, None)})
        if model_config is not None and model_config.gated_ffn:
            blocks["fcg_w"] = (pp, None, mp)
            if use_bias:
                blocks["fcg_b"] = (pp, mp)
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


AXES = ("dp", "pp", "sharding", "mp", "ep", "cp")    # `build_mesh`'s order


def coords(cfg: MeshConfig, r: int) -> Dict[str, int]:
    """Rank r's mesh coordinates, in the reference's `build_mesh` order:
    r = ((((dp * pp + p) * sharding + s) * mp + m) * ep + e) * cp + c."""
    co = {}
    for a in reversed(AXES):
        r, co[a] = divmod(r, getattr(cfg, a))
    return co


def data_index(cfg: MeshConfig, co) -> int:
    """The rank's place in the batch split over ("dp", "sharding", "ep")."""
    return (co["dp"] * cfg.sharding + co["sharding"]) * cfg.ep + co["ep"]


def axis_ranks(cfg: MeshConfig, co, axes) -> List[int]:
    """The ranks whose coordinates equal `co` on every axis but `axes`, in
    rank order."""
    return [r for r in range(cfg.size)
            if all(c == co[a] for a, c in coords(cfg, r).items()
                   if a not in axes)]


def _degree(cfg: MeshConfig, axis: str) -> int:
    return getattr(cfg, axis)


def _qkv_perm(name, spec, config, cfg):
    """The per-partition column order of an mp-split packed-qkv leaf."""
    if name.split("/")[-1] in ("qkv_w", "qkv_b") and spec[-1] == "mp":
        return torch.as_tensor(qkv_partition_perm(config, cfg.mp))
    return None


def stage_layers(cfg: MeshConfig, L: int, p: int) -> Optional[List[int]]:
    """The layers stage p holds under interleaving (vpp > 1, L divisible
    by pp * vpp), chunk-major: chunk c's are layers (c * pp + p) * Lc ..
    + Lc.  None: stage p holds the contiguous L / pp."""
    if cfg.vpp == 1 or L % (cfg.pp * cfg.vpp):
        return None
    Lc = L // (cfg.pp * cfg.vpp)
    return [(c * cfg.pp + p) * Lc + j for c in range(cfg.vpp)
            for j in range(Lc)]


def _part(axis, dim, n, co, cfg: MeshConfig, full: int):
    """The rank's part of a dimension of size `full` split over `axis`
    into parts of n: a slice, or under interleaving its layer list."""
    if axis == "pp" and dim == 0:
        layers = stage_layers(cfg, full, co["pp"])
        if layers is not None:
            return torch.as_tensor(layers)
    return slice(co[axis] * n, (co[axis] + 1) * n)


def cut_shard(t, spec, co, cfg: MeshConfig, perm=None):
    """Rank `co`'s shard of the full leaf `t` under `spec` (the packed
    qkv's columns first in the per-partition layout `perm`; under vpp the
    stage's interleaved layers), a contiguous tensor of its own."""
    if perm is not None:
        t = t.index_select(-1, perm.to(t.device))
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = t.shape[dim] // _degree(cfg, axis)
            part = _part(axis, dim, n, co, cfg, t.shape[dim])
            t = t.narrow(dim, part.start, n) if isinstance(part, slice) \
                else t.index_select(dim, part.to(t.device))
    return t.contiguous().clone()


def assemble(shards, spec, shape, cfg: MeshConfig, perm=None):
    """The full leaf from every rank's shard (rank order), in the
    reference layout (the qkv columns un-permuted, every layer in its
    place)."""
    full = torch.empty(shape, dtype=shards[0].dtype)
    for r, s in enumerate(shards):
        co = coords(cfg, r)
        idx = tuple(slice(None) if a is None else
                    _part(a, d, s.shape[d], co, cfg, shape[d])
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
    the data group, the MoE FFN over the rank's routing group and its ep
    peers (`moe_ffn`), and under ZeRO-3 the layers gathered at each
    use."""

    def __init__(self, handle, cfg: MeshConfig, groups, co):
        self.handle, self.groups = handle, groups
        self.device = handle.device
        self.mp, self.rank = cfg.mp, co["mp"]
        self.sequence_parallel = cfg.sequence_parallel and cfg.mp > 1
        self.ep = cfg.ep
        self.evaluating = False
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

    # ---- MoE -------------------------------------------------------------
    @property
    def route(self):
        """The ranks of this rank's routing group: the data group's
        contiguous 1/ep (the reference's ep groups), or the whole data
        group in `eval_loss` (the reference evaluates with one group)."""
        return self.groups["data" if self.evaluating else "route"]

    def _sp(self) -> int:
        return self.mp if self.sequence_parallel else 1

    def moe_ffn(self, bp, h, config):
        """The MoE FFN of h [B, S(/mp), D] -> (y like h, the rank's aux
        term).  Under sequence parallelism the rows are gathered over mp
        first (each mp rank routes the full sequences, as every rank does
        without it) and the rank's rows taken back after the combine.  The
        aux term is the group's load-balance loss over ep (the mean over
        the groups, as `psum(aux) / ep`) and over mp under sequence
        parallelism, so that the gradients summed over the mesh count it
        once."""
        x = mp_ops.gather_from_sp(h, self.groups["mp"]) \
            if self.sequence_parallel else h
        y, aux = moe_local(bp, x.reshape(-1, config.hidden_size), config,
                           self.route, self.groups["ep"])
        y = y.reshape(x.shape)
        if self.sequence_parallel:
            y = y.narrow(1, self.rank * h.shape[1], h.shape[1])
        ep = 1 if self.evaluating else self.ep
        return y, aux / (ep * self._sp())

    def penalty_share(self, pen, group):
        """The MoE penalty in the reported loss: the ranks' terms (`pen`,
        after `moe_ffn`'s division) summed over `group` (the data group,
        and pp under a pipeline), each routing group's counted once."""
        if pen is None:
            return 0.0
        share = pen.detach() * (self._sp() / self.route.size)
        return group.all_reduce(share.float().clone())

    # ---- ZeRO-3 ----------------------------------------------------------
    def layers(self, blocks):
        if not self.z3:
            return gpt_mod._layers(blocks)
        unbound = {k: v.unbind(0) for k, v in blocks.items()}
        # a leaf split over its layers ("bcast") holds its owner's share
        sh = self.groups["sharding"].size
        n = max(len(u) * (sh if self.z3.get(k, ("",))[0] == "bcast" else 1)
                for k, u in unbound.items())
        return (_Z3Layer(self, l, unbound, self.anchors) for l in range(n))

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


# named groups: the axes each spans; "data" is the batch split of dense
# leaves, "edata" of expert leaves (owned by their ep rank), "data_pp" of
# the leaves every pipeline stage holds a copy of
_AXIS_GROUPS = (("mp", ("mp",)), ("sharding", ("sharding",)),
                ("dp", ("dp",)), ("ep", ("ep",)), ("pp", ("pp",)),
                ("data", ("dp", "sharding", "ep")),
                ("edata", ("dp", "sharding")),
                ("data_pp", ("dp", "sharding", "ep", "pp")),
                ("world", AXES))


def _groups(handle, cfg: MeshConfig, r: int):
    """Rank r's groups, each in rank order, asked for in one order on
    every rank: the axis groups above; each sum group without the zero
    axis ("<name>_rest", the rest of a ZeRO reduce-scatter); "route", the
    rank's MoE routing group (its data index's contiguous 1/ep of the data
    group); and under pp the point-to-point links to the next and the
    previous stage ("pp_next", "pp_prev": one process group per directed
    link, apart from every collective group, built in link order, the
    ring's wrap only under vpp)."""
    co = coords(cfg, r)
    groups = {name: handle.group(name, axis_ranks(cfg, co, axes))
              for name, axes in _AXIS_GROUPS}
    zero = cfg.zero_axis
    for name in ("data", "edata", "data_pp"):
        axes = dict(_AXIS_GROUPS)[name]
        groups[name + "_rest"] = handle.group(
            name + "_rest", axis_ranks(cfg, co, [a for a in axes
                                                 if a != zero]))
    span = cfg.dp * cfg.sharding
    g = data_index(cfg, co) // span
    groups["route"] = handle.group("route", [
        q for q in groups["data"].ranks
        if data_index(cfg, coords(cfg, q)) // span == g])
    if cfg.pp > 1:
        stage = groups["pp"].ranks
        p, pp = co["pp"], cfg.pp
        links = [i for i in range(pp if cfg.vpp > 1 else pp - 1)
                 if p in (i, (i + 1) % pp)]
        for i in sorted(links):
            name = "pp_next" if i == p else "pp_prev"
            groups[name] = handle.group(name, [stage[i],
                                               stage[(i + 1) % pp]],
                                        link=True)
    return groups


# the trees of a trainer's state: the parameters and the AdamW moments
STATE_KEYS = ("params", "m", "v")


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
        self.view = _RankView(handle, cfg, self.groups, co)
        pspecs, mspecs, _ = trainer_specs(self.config, cfg)
        zero = cfg.zero_axis
        for lay, name, p, ps, ms in zip(
                self.layout, _names(self.params), _leaves(self.params),
                _leaves(pspecs), _leaves(mspecs)):
            lay["mp_split"] = "mp" in ps
            lay["pp_split"] = "pp" in ps
            lay["expert"] = name.split("/")[-1] in EXPERT_KEYS
            # the group a leaf's gradient sums over: the batch split of its
            # kind, and every stage's copy of a leaf that pp does not split
            lay["sum"] = "edata" if lay["expert"] else \
                "data_pp" if cfg.pp > 1 and not lay["pp_split"] else "data"
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
        before any reduction (under pp, `pipeline.train_grads`)."""
        if self.cfg.pp > 1:
            return pipeline.train_grads(self, _leaves(self.params),
                                        self._batch(tokens),
                                        self._batch(labels))
        leaves = _leaves(self.params)
        view = self.view
        anchors = list(view.anchors.values()) if view is not None else []
        with (view.saving() if view is not None
              else contextlib.nullcontext()):
            mean, pen = gpt_mod.loss_parts(
                self.params, self._batch(tokens), self._batch(labels),
                self.config, remat=self.cfg.remat, mesh=view)
        loss = mean if pen is None else mean + pen
        # leaves the config never reads (RMSNorm's ln*_b) get zeros, as
        # under jax.grad, so weight decay still reaches them
        grads = torch.autograd.grad(loss, leaves + anchors, allow_unused=True,
                                    materialize_grads=True)[:len(leaves)]
        if view is not None:
            return self._reported(mean, pen), grads
        return loss.detach(), grads

    def _reported(self, mean, pen):
        """The loss on a mesh: the ranks' terms summed over the data
        group, the MoE penalty counted once."""
        data = self.groups["data"]
        return data.all_reduce(mean.detach().clone()) + \
            self.view.penalty_share(pen, data)

    def train_step(self, tokens, labels):
        loss, grads = self.loss_and_grads(tokens, labels)
        self.apply_gradients(grads)
        return loss

    def eval_loss(self, tokens, labels):
        """The loss without a step; on a mesh MoE routes the whole batch as
        one group, as the reference's `eval_loss` does."""
        if self.cfg.pp > 1:
            return pipeline.eval_loss(self, self._batch(tokens),
                                      self._batch(labels))
        view = self.view
        if view is not None:
            view.evaluating = True
        try:
            with torch.no_grad():
                mean, pen = gpt_mod.loss_parts(
                    self.params, self._batch(tokens), self._batch(labels),
                    self.config, mesh=view)
                if view is not None:
                    return self._reported(mean, pen)
            return mean if pen is None else mean + pen
        finally:
            if view is not None:
                view.evaluating = False

    # ---- the update --------------------------------------------------------
    def _owned(self, grads):
        """Each leaf's gradient reduced over the mesh, as the slice of it
        this rank updates, and the slice's index (None: the whole shard).
        A leaf sums over its `sum` group (the data group of its kind, and
        pp for the leaves every stage holds): stage 0-1 all-reduce over
        it; stage 2-3 all-reduce over it without the zero axis
        ("<sum>_rest"), then reduce-scatter to the owner over the zero
        group (ZeRO-3 block leaves: summed over the sharding group by their
        gather's backward already)."""
        if self.view is None:
            return [(g, None) for g in grads]
        cfg, gr = self.cfg, self.groups
        out = []
        # the gradients are autograd's fresh tensors: reduced in place
        for g, lay in zip(grads, self.layout):
            g = g.contiguous()
            if self.view.sequence_parallel and not lay["mp_split"]:
                g = gr["mp"].all_reduce(g)      # partial over the rows
            d, group = lay["zero_dim"], lay["sum"]
            if lay["param_zero"]:
                out.append((gr[group + "_rest"].all_reduce(g), None))
            elif d is None:
                out.append((gr[group].all_reduce(g), None))
            elif cfg.sharding_stage >= 2:
                g = gr[group + "_rest"].all_reduce(g)
                out.append((self.zero_group.reduce_scatter(g, d), d))
            else:
                g = gr[group].all_reduce(g)
                n = g.shape[d] // self.zero_group.size
                out.append((g.narrow(d, self.zero_group.rank * n, n), d))
        return out

    def _counted(self, lay) -> bool:
        """Whether this rank counts its owned slice of a leaf in the global
        norm, so that every element of the gradient counts once: one rank
        of each axis that holds copies of it (mp unless it is split there,
        pp unless its layers are, ep unless it is an expert leaf, and the
        data axes but the zero axis of the slice)."""
        co = self.coords
        if not lay["mp_split"] and co["mp"] != 0:
            return False
        if not lay["pp_split"] and co["pp"] != 0:
            return False
        if not lay["expert"] and co["ep"] != 0:
            return False
        if lay["param_zero"] or lay["zero_dim"] is not None:
            return self.cfg.zero_axis == "dp" or co["dp"] == 0
        return co["dp"] == 0 and co["sharding"] == 0

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
                gnorm = torch.sqrt(self.groups["world"].all_reduce(sq))
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

    def host_state(self, keys=STATE_KEYS):
        host = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        trees = {"params": self.params, **self.opt_state}
        return {"step": self.opt_state["step"],
                **{k: _map(host, trees[k]) for k in keys}}


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
    if what == "grads":
        return [g for g, _ in rt._owned(rt.loss_and_grads(*args)[1])]
    if what == "shapes":
        return rt.shapes()
    if what == "state":
        return rt.host_state(*args)
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
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()    # the card is shared by the ranks
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
        elif mesh.mp != size:   # a larger mesh: `mesh.first(size)`
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
            self, _close_trainer, weakref.ref(getattr(mesh, "parent", mesh)),
            self._tid, size, mesh if own else None)

    def _draw(self, seed):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return gpt_mod.init_params(self.config, gen, self.device)

    def _call(self, what, per_rank_args=None):
        # the trainers dropped since the last call, sent to the ranks this
        # call reaches and kept for the ranks beyond them
        n = self.mesh.mp
        state = self.mesh.state
        pending = state.get("dropped_trainers", [])
        state["dropped_trainers"] = [(t, k) for t, k in pending if k > n]
        drops = [t for t, _ in pending]
        per = per_rank_args or [()] * n
        return self.mesh.run(_rank_call, [((self._tid, what, a, drops), {})
                                          for a in per])

    def _batches(self, tokens, labels, micro: int = 0):
        """Each rank's batch rows, split over dp x sharding x ep in the
        reference's order (`data_index`).  micro > 0 (pp): the batch cut
        first into `micro` contiguous microbatches, each of them split
        over the data ranks; a rank's rows are then [micro, rows, S]."""
        cfg = self.cfg
        tok, lab = np.asarray(tokens), np.asarray(labels)
        data = cfg.dp * cfg.sharding * cfg.ep
        B, S = tok.shape
        M = max(micro, 1)
        mb = B // M
        if mb % data:
            raise ValueError(
                f"batch {B} does not divide over dp x sharding x ep = {data}"
                + (f" in {M} microbatches" if M > 1 else ""))
        if cfg.sequence_parallel and cfg.mp > 1 and S % cfg.mp:
            raise ValueError(f"sequence length {S} does not divide over "
                             f"mp={cfg.mp} under sequence_parallel")
        b = mb // data
        out = []
        for r in range(self.mesh.mp):
            i = data_index(cfg, coords(cfg, r))
            rows = np.concatenate([np.arange(m * mb + i * b,
                                             m * mb + (i + 1) * b)
                                   for m in range(M)])
            t, lab_r = tok[rows], lab[rows]
            if micro:
                t, lab_r = t.reshape(M, b, S), lab_r.reshape(M, b, S)
            out.append((t, lab_r))
        return out

    def _check_pipeline(self, B: int) -> None:
        """The reference's `_pp_loss` AssertionErrors, in its order."""
        cfg, M, L = self.cfg, self.cfg.micro_batches, self.config.num_layers
        moe_ep = self.config.moe_num_experts > 0 and cfg.ep > 1
        for bad, msg in (
                (B % M, f"batch {B} must divide into micro_batches={M} (pad "
                 "the batch; uneven microbatches are not supported)"),
                (moe_ep and (B // M) % cfg.ep,
                 f"microbatch {B // M} must divide over ep={cfg.ep}"),
                (cfg.vpp > 1 and M % cfg.pp,
                 f"interleaved schedule needs micro_batches {M} % pp "
                 f"{cfg.pp} == 0"),
                (cfg.vpp > 1 and L % (cfg.pp * cfg.vpp),
                 f"layers {L} must divide over pp*vpp")):
            if bad:
                raise AssertionError(msg)

    # ---- the step ----------------------------------------------------------
    def train_step(self, tokens, labels):
        """One step on tokens/labels [B, S]; returns the loss before the
        update (a 0-d f32 tensor on the first device).  Under pp the batch
        runs as `micro_batches` microbatches through the stages
        (`parallel.pipeline`)."""
        if self.mesh is None:
            return self._local.train_step(tokens, labels)
        micro = 0
        if self.cfg.pp > 1:
            self._check_pipeline(np.shape(tokens)[0])
            micro = self.cfg.micro_batches
        return self._call("step", self._batches(tokens, labels, micro))[0]

    def train_step_routes(self, tokens, labels):
        """`train_step` with the MoE router's choices logged, a witness of
        where two layouts route a token apart: (loss, gate_idx [L, B * S,
        k] int32, probs [L, B * S, E] float32), each layer's choices in the
        forward pass, in the batch's row-major token order, on the CPU."""
        if not self.config.moe_num_experts:
            raise ValueError("train_step_routes needs an MoE config")
        def toggle(on):
            if self.mesh is None:
                return [log_routes(on)]
            return self.mesh.run(log_routes, [((on,), {})] * self.mesh.mp)

        toggle(True)
        try:
            loss = self.train_step(tokens, labels)
        finally:
            logs = toggle(False)
        return (loss,) + self._place_routes(logs, *np.shape(tokens))

    def _place_routes(self, logs, B: int, S: int):
        """Each rank's logged forward routes at their layers and tokens.
        A rank logs its units' chunks in order (`pipeline.units`), every
        forward before any backward or remat replay; it routes its rows of
        the microbatch (`_batches`), full sequences under sequence
        parallelism, which each mp rank routes alike (the first's are
        taken)."""
        cfg, c = self.cfg, self.config
        L, k, E = c.num_layers, c.moe_topk, c.moe_num_experts
        M = cfg.micro_batches if cfg.pp > 1 else 1
        b = B // M // (cfg.dp * cfg.sharding * cfg.ep)
        idx = torch.full((L, B * S, k), -1, dtype=torch.int32)
        probs = torch.zeros(L, B * S, E)
        for r, log in enumerate(logs):
            co = coords(cfg, r)
            if co["mp"]:
                continue
            p, i, Lp = co["pp"], data_index(cfg, co), L // cfg.pp
            held = stage_layers(cfg, L, p) or list(range(p * Lp,
                                                         (p + 1) * Lp))
            Lc = len(held) // cfg.vpp
            order = [(held[ch * Lc + j], m)
                     for ch, m in pipeline.units(cfg.pp, cfg.vpp, M)
                     for j in range(Lc)]
            if len(log) < len(order):
                raise RuntimeError(f"rank {r} logged {len(log)} routes, its "
                                   f"forward runs {len(order)}")
            for (layer, m), (pr, gi) in zip(order, log):
                t0 = (m * (B // M) + i * b) * S
                idx[layer, t0:t0 + b * S] = gi
                probs[layer, t0:t0 + b * S] = pr
        return idx, probs

    def eval_loss(self, tokens, labels):
        """The loss of tokens/labels without a step (under pp the batch
        goes through the stages as one microbatch)."""
        if self.mesh is None:
            return self._local.eval_loss(tokens, labels)
        cfg, L = self.cfg, self.config.num_layers
        if cfg.vpp > 1 and L % (cfg.pp * cfg.vpp):
            raise AssertionError(f"layers {L} must divide over pp*vpp")
        micro = 1 if cfg.pp > 1 else 0
        return self._call("eval", self._batches(tokens, labels, micro))[0]

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

    def gathered_state(self, keys=STATE_KEYS) -> Dict[str, Any]:
        """{"params", "m", "v", "step"} (of the trees, those in `keys`): the
        full trees on the CPU in the reference layout (the packed qkv
        columns un-permuted)."""
        keys = tuple(keys)
        if self.mesh is None:
            return self._local.host_state(keys)
        states = self._call("state", [(keys,)] * self.mesh.mp)
        pspecs, mspecs, shapes = trainer_specs(self.config, self.cfg)
        out = {"step": states[0]["step"]}
        names = _names(shapes)
        for key, specs in (("params", pspecs), ("m", mspecs),
                           ("v", mspecs)):
            if key not in keys:
                continue
            full = [assemble([_leaves(s[key])[i] for s in states], sp, sh,
                             self.cfg, _qkv_perm(n, sp, self.config,
                                                 self.cfg))
                    for i, (n, sp, sh) in enumerate(zip(
                        names, _leaves(specs), _leaves(shapes)))]
            out[key] = _fill(shapes, full)
        return out

    def gathered_grads(self, tokens, labels) -> Dict[str, Any]:
        """The gradients of the loss of tokens/labels at the current
        parameters, reduced over the mesh as a step reduces them (before
        the clip) and gathered into full trees in the reference layout; no
        update.  For parity checks."""
        if self.mesh is None:
            return _fill(self.params, [g.detach().cpu() for g in
                                       self._local.loss_and_grads(
                                           tokens, labels)[1]])
        micro = self.cfg.micro_batches if self.cfg.pp > 1 else 0
        per = self._call("grads", self._batches(tokens, labels, micro))
        _, mspecs, shapes = trainer_specs(self.config, self.cfg)
        return _fill(shapes, [
            assemble([g[i] for g in per], sp, sh, self.cfg,
                     _qkv_perm(n, sp, self.config, self.cfg))
            for i, (n, sp, sh) in enumerate(zip(
                _names(shapes), _leaves(mspecs), _leaves(shapes)))])

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


def _close_trainer(mesh_ref, tid, size, own_mesh):
    """A dropped trainer's rank states: gone with its own mesh, or dropped
    at the next trainer calls that reach its `size` ranks on a shared one
    (a finalizer must not talk to the workers: it may run inside another
    call)."""
    if own_mesh is not None:
        own_mesh.close()
        return
    mesh = mesh_ref()
    if mesh is not None:
        mesh.state.setdefault("dropped_trainers", []).append((tid, size))


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
