"""Loss functionals — port of `paddle_tpu/nn/functional/loss.py`
(reference `python/paddle/nn/functional/loss.py`).

Each loss is the reference's formula in torch inside `apply`.  Three are
algorithms of their own:

- `ctc_loss` is optax's `ctc_loss` (the reference calls it), written out:
  the log-space forward algorithm over the log-softmax of the input, with
  log(0) approximated by -1e5, so an infeasible alignment gives a large
  finite loss as optax's does (torch's `F.ctc_loss` gives inf there); the
  mean divides each sequence's loss by its label length.
- `rnnt_loss` is the reference's forward-variable DP, a loop over T and U,
  with FastEmit's straight-through term on the emit log-probabilities.
- `class_center_sample` draws its negatives with numpy's `RandomState(0)`,
  as the reference does, so both pick the same classes.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as _F

from ...core.tensor import Tensor, _device_of, apply
from .common import _one_hot


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


_SOFT_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def _pick(lp, idx, axis):
    """lp's entries at class `idx` along `axis` (idx has lp's shape less
    that axis)."""
    return torch.gather(lp, axis, idx.long().unsqueeze(axis)).squeeze(axis)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy: f32 log-softmax, soft labels (or float labels
    of the logits' shape), `label_smoothing`, `ignore_index`, and `weight`
    with its weighted mean."""
    def f(logits, lab, *rest):
        w = rest[0] if rest else None
        l32 = logits.float()
        lp = torch.log_softmax(l32, axis) if use_softmax \
            else torch.log(torch.clamp(l32, min=1e-30))
        k = logits.shape[axis]
        if soft_label or (lab.dtype in _SOFT_DTYPES and
                          lab.shape == logits.shape):
            sl = lab.float()
            if label_smoothing > 0.0:
                sl = sl * (1 - label_smoothing) + label_smoothing / k
            return _reduce(-torch.sum(sl * lp, dim=axis), reduction)
        li = lab.long()
        if li.ndim == lp.ndim and li.shape[axis] == 1:
            li = li.squeeze(axis)
        ignored = li == ignore_index
        safe = torch.where(ignored, 0, li)
        if label_smoothing > 0.0:
            onehot = torch.movedim(_one_hot(li, k), -1, axis % lp.ndim)
            sl = onehot * (1 - label_smoothing) + label_smoothing / k
            loss = -torch.sum(sl * lp, dim=axis)
        else:
            loss = -_pick(lp, safe, axis)
        loss = torch.where(ignored, 0.0, loss)
        if w is not None:
            wv = torch.where(ignored, 0.0, w.float()[safe])
            loss = loss * wv
            if reduction == "mean":
                return loss.sum() / torch.clamp(wv.sum(), min=1e-12)
        if reduction == "mean":
            return loss.sum() / torch.clamp((~ignored).float().sum(), min=1.0)
        return _reduce(loss, reduction)
    args = (input, label) + ((weight,) if weight is not None else ())
    return apply("cross_entropy", f, *args)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    def f(lg, lab):
        sm = torch.softmax(lg.float(), axis)
        lp = torch.log_softmax(lg.float(), axis)
        if soft_label:
            loss = -torch.sum(lab.float() * lp, dim=axis, keepdim=True)
        else:
            li = lab.long()
            idx = li if li.ndim == lp.ndim and li.shape[axis] == 1 \
                else li.unsqueeze(axis)
            ignored = idx == ignore_index
            loss = -torch.gather(lp, axis, torch.where(ignored, 0, idx))
            loss = torch.where(ignored, 0.0, loss)
        if return_softmax:
            return loss.to(lg.dtype), sm.to(lg.dtype)
        return loss.to(lg.dtype)
    return apply("softmax_with_cross_entropy", f, logits, label)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    def f(lp, lab, *rest):
        li = lab.long()
        safe = torch.where(li == ignore_index, 0, li)
        loss = -_pick(lp, safe, 1)
        mask = (li != ignore_index).float()
        if rest:
            wv = rest[0][safe] * mask
            loss = loss * wv
            if reduction == "mean":
                return loss.sum() / torch.clamp(wv.sum(), min=1e-12)
        else:
            loss = loss * mask
            if reduction == "mean":
                return loss.sum() / torch.clamp(mask.sum(), min=1.0)
        return _reduce(loss, reduction)
    args = (input, label) + ((weight,) if weight is not None else ())
    return apply("nll_loss", f, *args)


def mse_loss(input, label, reduction="mean", name=None):
    return apply("mse_loss", lambda a, b: _reduce((a - b) ** 2, reduction),
                 input, label)


def l1_loss(input, label, reduction="mean", name=None):
    return apply("l1_loss", lambda a, b: _reduce((a - b).abs(), reduction),
                 input, label)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def f(a, b):
        d = (a - b).abs()
        return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                                   d - 0.5 * delta), reduction)
    return apply("smooth_l1_loss", f, input, label)


def square_error_cost(input, label):
    return apply("square_error_cost", lambda a, b: (a - b) ** 2, input, label)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def f(p, y, *rest):
        p32 = torch.clamp(p.float(), 1e-12, 1.0 - 1e-7)
        loss = -(y * torch.log(p32) + (1 - y) * torch.log1p(-p32))
        if rest:
            loss = loss * rest[0]
        return _reduce(loss, reduction)
    args = (input, label) + ((weight,) if weight is not None else ())
    return apply("binary_cross_entropy", f, *args)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    def f(z, y, *rest):
        it = iter(rest)
        w = next(it) if weight is not None else None
        pw = next(it) if pos_weight is not None else None
        z32, y32 = z.float(), y.float()
        soft = torch.log1p(torch.exp(-z32.abs()))
        if pw is None:
            loss = torch.clamp(z32, min=0) - z32 * y32 + soft
        else:
            log_w = 1 + (pw - 1) * y32
            loss = (1 - y32) * z32 + log_w * (soft + torch.clamp(-z32, min=0))
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)
    args = [logit, label] + [t for t in (weight, pos_weight) if t is not None]
    return apply("bce_with_logits", f, *args)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    def f(lp, y):
        if log_target:
            loss = torch.exp(y) * (y - lp)
        else:
            loss = torch.where(y > 0, y * (torch.log(torch.clamp(y, min=1e-30))
                                           - lp), 0.0)
        if reduction == "batchmean":
            return loss.sum() / lp.shape[0]
        return _reduce(loss, reduction)
    return apply("kl_div", f, input, label)


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply("log_loss", lambda p, y: -y * torch.log(p + epsilon)
                 - (1 - y) * torch.log(1 - p + epsilon), input, label)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    def f(a, y):
        return _reduce(torch.where(y == 1.0, a, torch.clamp(margin - a,
                                                            min=0.0)),
                       reduction)
    return apply("hinge_embedding_loss", f, input, label)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply("margin_ranking_loss", lambda a, b, y: _reduce(
        torch.clamp(-y * (a - b) + margin, min=0.0), reduction),
        input, other, label)


def cosine_embedding_loss(input1, input2, label, margin=0.0, reduction="mean",
                          name=None):
    def f(a, b, y):
        cos = torch.sum(a * b, dim=-1) / torch.clamp(
            torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1),
            min=1e-12)
        return _reduce(torch.where(y == 1, 1 - cos,
                                   torch.clamp(cos - margin, min=0.0)),
                       reduction)
    return apply("cosine_embedding_loss", f, input1, input2, label)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean", name=None):
    def f(a, pos, neg):
        def dist(u, v):
            return torch.pow(torch.sum(torch.pow((u - v).abs() + epsilon, p),
                                       dim=-1), 1.0 / p)
        d_ap, d_an = dist(a, pos), dist(a, neg)
        if swap:
            d_an = torch.minimum(d_an, dist(pos, neg))
        return _reduce(torch.clamp(d_ap - d_an + margin, min=0.0), reduction)
    return apply("triplet_margin_loss", f, input, positive, negative)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    def f(z, y, *rest):
        loss = -(y * _F.logsigmoid(z) + (1 - y) * _F.logsigmoid(-z))
        loss = loss.mean(-1)
        if rest:
            loss = loss * rest[0]
        return _reduce(loss, reduction)
    args = (input, label) + ((weight,) if weight is not None else ())
    return apply("multi_label_soft_margin_loss", f, *args)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return apply("soft_margin_loss", lambda z, y: _reduce(
        torch.log1p(torch.exp(-y * z)), reduction), input, label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def f(z, y, *rest):
        p = torch.sigmoid(z)
        ce = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * torch.pow(1 - p_t, gamma) * ce
        if rest:
            loss = loss / rest[0]
        return _reduce(loss, reduction)
    args = (logit, label) + ((normalizer,) if normalizer is not None else ())
    return apply("sigmoid_focal_loss", f, *args)


def dice_loss(input, label, epsilon=1e-5, name=None):
    def f(p, y):
        yf = _one_hot(y.squeeze(-1), p.shape[-1], p.dtype)
        red = tuple(range(1, p.ndim))
        inter = torch.sum(p * yf, dim=red)
        union = torch.sum(p, dim=red) + torch.sum(yf, dim=red)
        return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))
    return apply("dice_loss", f, input, label)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    def f(a, p, lab):
        logits = a @ p.T
        same = (lab.reshape(-1, 1) == lab.reshape(1, -1)).float()
        same = same / same.sum(1, keepdim=True)
        xent = torch.mean(torch.sum(-same * torch.log_softmax(logits, 1), 1))
        reg = l2_reg * (torch.mean(torch.sum(a * a, 1))
                        + torch.mean(torch.sum(p * p, 1))) * 0.25
        return xent + reg
    return apply("npair_loss", f, anchor, positive, labels)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    def f(z, y):
        if log_input:
            loss = torch.exp(z) - y * z
        else:
            loss = z - y * torch.log(z + epsilon)
        if full:
            stirling = y * torch.log(y + epsilon) - y + \
                0.5 * torch.log(2 * math.pi * (y + epsilon))
            loss = loss + torch.where(y > 1, stirling, 0.0)
        return _reduce(loss, reduction)
    return apply("poisson_nll_loss", f, input, label)


_LOG_EPS = -1e5     # optax's log(0)


def _ctc_per_sequence(logits, logitpad, labels, labelpad, blank):
    """optax's `ctc_loss`: logits [B, T, K], paddings [B, T] and [B, N]
    (1.0 where padded), labels [B, N] -> the loss of each sequence [B]."""
    B, T, K = logits.shape
    N = labels.shape[1]
    lp = torch.log_softmax(logits, -1)
    labellens = N - labelpad.sum(1).long()
    repeat = (labels[:, :-1] == labels[:, 1:]).float()
    repeat = torch.cat([repeat, repeat.new_zeros(B, 1)], 1)
    lp_phi = lp[:, :, blank]                                    # [B, T]
    lp_emit = torch.einsum("btk,bnk->btn", lp, _one_hot(labels, K))
    phi = torch.full((B, N + 1), _LOG_EPS, device=lp.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), _LOG_EPS, device=lp.device)

    def add_phi(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], 1)

    for t in range(T):
        prev_phi_orig = phi
        prev_phi = add_phi(phi, emit + _LOG_EPS * repeat)
        e_t, p_t = lp_emit[:, t], lp_phi[:, t:t + 1]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e_t, emit + e_t)
        next_phi = add_phi(prev_phi + p_t,
                           emit + p_t + _LOG_EPS * (1.0 - repeat))
        pad = logitpad[:, t:t + 1]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = add_phi(phi, emit)
    return -torch.einsum("bn,bn->b", last, _one_hot(labellens, N + 1))


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """log_probs [T, B, V], labels [B, N]; "mean" averages each sequence's
    loss over its label length."""
    def f(lp, lab, il, ll):
        logits = lp.transpose(0, 1).float()
        B, T, _ = logits.shape
        logitpad = (torch.arange(T, device=lp.device)[None, :] >=
                    il[:, None]).float()
        labelpad = (torch.arange(lab.shape[1], device=lp.device)[None, :] >=
                    ll[:, None]).float()
        per = _ctc_per_sequence(logits, logitpad, lab.long(), labelpad, blank)
        if reduction == "mean":
            return torch.mean(per / torch.clamp(ll.float(), min=1.0))
        return _reduce(per, reduction)
    return apply("ctc_loss", f, log_probs, labels, input_lengths,
                 label_lengths)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    def f(mu, y, var):
        v = torch.clamp(var, min=epsilon)
        loss = 0.5 * (torch.log(v) + (y - mu) ** 2 / v)
        if full:
            loss = loss + 0.5 * math.log(2 * math.pi)
        return _reduce(loss, reduction)
    return apply("gaussian_nll_loss", f, input, label, variance)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    def f(x, y, *w):
        n, c = x.shape
        yi = y.long()
        picked = torch.gather(x, 1, yi[:, None])
        m = torch.clamp(margin - picked + x, min=0.0) ** p
        if w:
            # the whole sample is weighted by weight[y], as in the reference
            m = m * w[0][yi][:, None]
        m = m.index_put((torch.arange(n, device=x.device), yi),
                        m.new_zeros(()))
        return _reduce(m.sum(1) / c, reduction)
    args = (input, label) + ((weight,) if weight is not None else ())
    return apply("multi_margin_loss", f, *args)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean", name=None):
    def pairwise(a, b):
        return torch.sqrt(torch.sum((a - b) ** 2, dim=-1) + 1e-12)

    if distance_function is not None:
        dp = distance_function(input, positive)
        dn = distance_function(input, negative)
        if swap:
            dn = apply("minimum", torch.minimum, dn,
                       distance_function(positive, negative))
        loss = apply("triplet_hinge",
                     lambda a, b: torch.clamp(a - b + margin, min=0.0), dp, dn)
    else:
        def f(x, pos, neg):
            dn = pairwise(x, neg)
            if swap:
                dn = torch.minimum(dn, pairwise(pos, neg))
            return torch.clamp(pairwise(x, pos) - dn + margin, min=0.0)
        loss = apply("triplet_margin_with_distance", f, input, positive,
                     negative)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False, name=None):
    """Hierarchical sigmoid over the default complete binary tree (internal
    nodes [0, C-2], leaves [C-1, 2C-2]; class c walks from leaf c + C - 1
    to the root), or over custom `path_table`/`path_code` rows (leaf to
    root, -1 padded; a binary cross-entropy a step with the code as
    label)."""
    if (path_table is None) != (path_code is None):
        raise ValueError("path_table and path_code must be given together")
    if path_table is not None:
        def fc(x, pt, pc, w, *b):
            nodes = pt.long().reshape(x.shape[0], -1)
            codes = pc.long().reshape(x.shape[0], -1)
            safe = torch.clamp(nodes, min=0)
            logits = torch.einsum("nld,nd->nl", w[safe], x)
            if b:
                logits = logits + b[0].reshape(-1)[safe]
            z = torch.where(codes > 0, -logits, logits)
            return torch.mean(torch.sum(torch.where(nodes >= 0, _F.softplus(z),
                                                    0.0), 1))
        args = (input, path_table, path_code, weight) + \
            ((bias,) if bias is not None else ())
        return apply("hsigmoid_loss", fc, *args)
    C = int(num_classes)
    depth = max(int(math.ceil(math.log2(max(C, 2)))) + 1, 1)

    def f(x, y, w, *b):
        node = y.long().reshape(-1) + (C - 1)
        total = 0.0
        for _ in range(depth):
            valid = node > 0
            parent = torch.clamp(torch.div(node - 1, 2, rounding_mode="floor"),
                                 min=0)
            logits = torch.einsum("nd,nd->n", w[parent], x)
            if b:
                logits = logits + b[0].reshape(-1)[parent]
            sign = torch.where(node == 2 * parent + 2, -1.0, 1.0)
            total = total + torch.where(valid, _F.softplus(-sign * logits),
                                        0.0)
            node = torch.where(valid, parent, 0)
        return torch.mean(total)
    args = (input, label, weight) + ((bias,) if bias is not None else ())
    return apply("hsigmoid_loss", f, *args)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0,
                         scale=64.0, group=None, return_softmax=False,
                         reduction="mean", name=None):
    """ArcFace/CosFace margins: cos(m1 * theta + m2) - m3 on the target
    logit, then the scaled cross entropy.  `group=False` is Paddle's "no
    parallelism"; a real group (vocab-sharded logits) is refused, as in
    the reference."""
    if group not in (None, False):
        raise NotImplementedError(
            "margin_cross_entropy(group=...) (model-parallel sharded logits) "
            "is not supported; gather the logits first")

    def f(lg, y):
        yi = y.long().reshape(-1)
        rows = torch.arange(lg.shape[0], device=lg.device)
        theta = torch.arccos(torch.clamp(lg[rows, yi], -1.0, 1.0))
        adj = torch.cos(margin1 * theta + margin2) - margin3
        lsm = torch.log_softmax(lg.index_put((rows, yi), adj) * scale, -1)
        loss = _reduce(-lsm[rows, yi], reduction)
        if return_softmax:
            return loss, torch.exp(lsm)
        return loss
    return apply("margin_cross_entropy", f, logits, label)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-T loss: input [B, T, U+1, V] (log-softmaxed here), label [B, U];
    the forward variables alpha[t, u] in log space, row by row (blank from
    the row above, then emits left to right within the row)."""
    def f(acts, lab, ilen, llen):
        lp = torch.log_softmax(acts, -1)
        B, T, U1, _ = lp.shape
        U = U1 - 1
        blank_lp = lp[..., blank]                              # [B, T, U+1]
        emit_lp = torch.gather(
            lp[:, :, :U, :], -1,
            lab.long()[:, None, :, None].expand(B, T, U, 1))[..., 0]
        if fastemit_lambda:
            # FastEmit: the loss is unchanged, emit gradients scale by
            # (1 + lambda)
            emit_lp = emit_lp + fastemit_lambda * (emit_lp - emit_lp.detach())
        NEG = -1e30
        first = torch.full((B, U1), NEG, dtype=lp.dtype, device=lp.device)
        first[:, 0] = 0.0
        alpha_prev, rows = None, []
        for t in range(T):
            top = first if t == 0 else alpha_prev + blank_lp[:, t - 1, :]
            cells = [top[:, 0]]
            for u in range(1, U1):
                cells.append(torch.logaddexp(top[:, u],
                                             cells[-1] + emit_lp[:, t, u - 1]))
            alpha_prev = torch.stack(cells, 1)
            rows.append(alpha_prev)
        alphas = torch.stack(rows, 1)                          # [B, T, U+1]
        bi = torch.arange(B, device=lp.device)
        tl, ul = ilen.long() - 1, llen.long()
        return _reduce(-(alphas[bi, tl, ul] + blank_lp[bi, tl, ul]),
                       reduction)
    return apply("rnnt_loss", f, input, label, input_lengths, label_lengths)


def class_center_sample(label, num_classes, num_samples, group=None):
    """(the labels remapped into the sampled classes, the sampled class
    indices): every positive class, then negatives drawn by numpy's
    `RandomState(0)` up to `num_samples`, as the reference draws them."""
    y = np.asarray(label.numpy() if hasattr(label, "numpy") else label) \
        .reshape(-1)
    pos = np.unique(y)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        neg_pool = np.setdiff1d(np.arange(num_classes), pos)
        extra = np.random.RandomState(0).choice(
            neg_pool, size=num_samples - len(pos), replace=False)
        sampled = np.concatenate([pos, np.sort(extra)])
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    dev = label._t.device if isinstance(label, Tensor) else _device_of(None)
    return (Tensor(torch.from_numpy(remap[y].reshape(y.shape)).to(dev)),
            Tensor(torch.from_numpy(sampled.astype(np.int64)).to(dev)))
