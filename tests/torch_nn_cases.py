"""The nn cases that the port's nn twins share (numpy only, so that a
machine without jax can load it).

A case is `torch_op_cases.Case`: `fn(ns, *tensors)` calls the namespace's
`nn.functional` (`ns` is `paddle_tpu` or `paddle_tpu_torch`) on seeded
numpy inputs; `grad` holds the input gradients too; the tolerance is
float32 2e-5 abs and rel unless the case states its own.
`tests/test_torch_nn_functional.py` runs each through both packages on the
CPU; `port_on_device` runs it through the port on a CUDA card against the
port on the CPU (`tests/test_torch_nn_cuda.py`, `chip_smoke.py`'s phase
8e (a)).

Tables: ACTIVATION, COMMON, INPUT (input, distance, extension), NORM,
LOSS and ATTENTION hold every public function of the slice's functional
modules; TROUBLE the spots where torch's defaults and the reference's
differ (`interpolate`'s modes, `gelu`'s two forms, `cross_entropy`'s
lanes, `ctc_loss`'s infeasible row, the DP and tree losses,
`class_center_sample`, `unfold`/`fold`, `gather_tree`).  RANDOM holds the
functions that draw (each package against itself: the two packages'
streams differ).  `carry` copies a reference Layer's parameters and
buffers into the port's twin.
"""
import numpy as np

from torch_op_cases import Case

_r = np.random.RandomState(11)


def _f32(*shape, scale=1.0, shift=0.0):
    return (_r.randn(*shape) * scale + shift).astype(np.float32)


def _pos(*shape):
    return (_r.rand(*shape) * 0.8 + 0.1).astype(np.float32)


def F(name, **kw):
    """A case fn calling `nn.functional.<name>(*tensors, **kw)`."""
    def fn(ns, *ts):
        return getattr(ns.nn.functional, name)(*ts, **kw)
    return fn


def fcase(name, inputs, grad=True, tol=None, label=None, **kw):
    return Case(label or name, F(name, **kw), inputs, grad=grad,
                **({"tol": tol} if tol is not None else {}))


X = _f32(3, 8)
X4 = _f32(2, 4, 3, 3)
# keep the piecewise activations' inputs off their kinks, where the two
# packages may pick different one-sided derivatives
XK = np.where(np.abs(X) < 0.05, 0.3, X).astype(np.float32)

ACTIVATION = [
    fcase("relu", [XK]), fcase("relu6", [XK * 4]), fcase("elu", [X]),
    fcase("elu", [X], alpha=0.5, label="elu_alpha"),
    fcase("celu", [X], alpha=1.5), fcase("selu", [X]),
    fcase("gelu", [X]), fcase("silu", [X]), fcase("swish", [X]),
    fcase("sigmoid", [X]), fcase("hardsigmoid", [XK]),
    fcase("hardswish", [XK * 3]), fcase("hardtanh", [XK * 2]),
    fcase("hardshrink", [XK]), fcase("softshrink", [XK]),
    fcase("tanhshrink", [X]), fcase("thresholded_relu", [XK * 2]),
    fcase("leaky_relu", [XK]),
    fcase("leaky_relu", [XK], negative_slope=0.2, label="leaky_relu_slope"),
    fcase("prelu", [XK, np.float32([0.25])], label="prelu_scalar"),
    fcase("prelu", [np.where(np.abs(X4) < 0.05, 0.3, X4).astype(np.float32),
                    np.float32([0.1, 0.2, 0.3, 0.4])], label="prelu_channels"),
    fcase("rrelu", [XK], training=False),
    fcase("maxout", [X4], groups=2), fcase("mish", [X]),
    fcase("softplus", [X * 8], beta=2.0, threshold=5.0),
    fcase("softsign", [X]), fcase("tanh", [X]), fcase("log_sigmoid", [X]),
    fcase("softmax", [X]), fcase("softmax", [X], axis=0, label="softmax_0"),
    fcase("log_softmax", [X]), fcase("glu", [X]),
    fcase("softmax", [X], dtype="float32", label="softmax_dtype"),
] + [fcase(n, [XK], grad=False) for n in
     ("relu_", "tanh_", "softmax_", "elu_", "hardtanh_", "leaky_relu_",
      "thresholded_relu_")]

IMG = _f32(2, 3, 4, 5)
PAIR_A, PAIR_B = _f32(4, 6), _f32(4, 6)
LABELS_SOFT = np.eye(6, dtype=np.float32)[[0, 3, 5, 1]]


def _pad_nd(ns, x):
    f = ns.nn.functional
    return (f.pad(x, [1, 2, 0, 1]), f.pad(x, [1, 1, 2, 0], mode="reflect"),
            f.pad(x, [1, 0, 1, 1], mode="replicate"), f.zeropad2d(x, [1, 1, 1, 1]))


COMMON = [
    fcase("linear", [_f32(3, 5), _f32(5, 4), _f32(4)], label="linear_bias"),
    fcase("linear", [_f32(2, 3, 5), _f32(5, 4)], label="linear"),
    fcase("dropout", [X], training=False, label="dropout_eval"),
    fcase("dropout", [X], p=0.3, training=False, mode="downscale_in_infer",
          label="dropout_downscale_infer"),
    fcase("dropout", [X], p=0.0, label="dropout_p0"),
    fcase("dropout2d", [IMG], training=False),
    fcase("dropout3d", [_f32(1, 2, 2, 2, 2)], training=False),
    fcase("alpha_dropout", [X], training=False),
    fcase("one_hot", [np.array([0, 3, 1, 4], np.int64)], grad=False,
          num_classes=5),
    fcase("label_smooth", [LABELS_SOFT]),
    fcase("label_smooth", [LABELS_SOFT, np.full((1, 6), 1 / 6, np.float32)],
          label="label_smooth_prior", epsilon=0.2),
    fcase("cosine_similarity", [PAIR_A, PAIR_B]),
    fcase("cosine_similarity", [PAIR_A, PAIR_B], axis=-1,
          label="cosine_similarity_last"),
    fcase("bilinear", [_f32(3, 4), _f32(3, 5), _f32(2, 4, 5), _f32(1, 2)]),
    Case("pad", _pad_nd, [IMG], grad=True),
    fcase("upsample", [IMG], scale_factor=2, mode="nearest"),
    fcase("unfold", [IMG], kernel_sizes=2),
    fcase("fold", [_f32(2, 12, 12)], output_sizes=[4, 5], kernel_sizes=2),
]

IDS = np.array([[1, 2, 0], [3, 9, 2]], np.int64)

INPUT = [
    fcase("embedding", [IDS, _f32(10, 4)]),
    fcase("embedding", [IDS, _f32(10, 4)], padding_idx=2,
          label="embedding_padding_idx"),
    fcase("pairwise_distance", [PAIR_A, PAIR_B]),
    fcase("pairwise_distance", [PAIR_A, PAIR_B], p=1.0, keepdim=True,
          label="pairwise_distance_p1"),
    fcase("diag_embed", [_f32(2, 3)]),
    fcase("sequence_mask", [np.array([2, 0, 4], np.int64)], grad=False),
    fcase("sequence_mask", [np.array([2, 3], np.int64)], grad=False,
          maxlen=5, dtype="float32", label="sequence_mask_maxlen"),
    fcase("temporal_shift", [_f32(4, 8, 2, 2)], seg_num=2),
    fcase("temporal_shift", [_f32(4, 2, 2, 8)], seg_num=2,
          data_format="NHWC", label="temporal_shift_nhwc"),
]

BN = _f32(4, 3, 2, 2, scale=5.0, shift=1.0)


def _batch_norm_train(ns, x, w, b):
    rm = ns.to_tensor(np.zeros(3, np.float32))
    rv = ns.to_tensor(np.ones(3, np.float32))
    out = ns.nn.functional.batch_norm(x, rm, rv, w, b, training=True)
    return out, rm, rv


NORM = [
    Case("layer_norm", lambda ns, x, w, b: ns.nn.functional.layer_norm(
        x, 8, w, b), [_f32(2, 3, 8), _f32(8), _f32(8)], grad=True),
    fcase("layer_norm", [_f32(2, 3, 4)], normalized_shape=[3, 4],
          label="layer_norm_2d"),
    fcase("batch_norm", [BN, _f32(3), _pos(3) + 0.5, _f32(3), _f32(3)],
          label="batch_norm_eval"),
    Case("batch_norm_train", _batch_norm_train, [BN, _f32(3), _f32(3)],
         grad=True),
    fcase("batch_norm", [np.moveaxis(BN, 1, -1).copy(), _f32(3), _pos(3),
                         _f32(3), _f32(3)], data_format="NHWC",
          label="batch_norm_nhwc"),
    Case("instance_norm", lambda ns, x, w, b: ns.nn.functional.instance_norm(
        x, weight=w, bias=b), [IMG, _f32(3), _f32(3)], grad=True),
    fcase("group_norm", [_f32(2, 4, 3, 3)], num_groups=2),
    Case("group_norm_nhwc", lambda ns, x, w, b: ns.nn.functional.group_norm(
        x, 2, weight=w, bias=b, data_format="NHWC"),
        [_f32(2, 3, 3, 4), _f32(4), _f32(4)], grad=True),
    fcase("normalize", [X]), fcase("normalize", [X], p=1, axis=0,
                                   label="normalize_p1"),
    fcase("local_response_norm", [_f32(2, 6, 3, 3)], size=3),
    Case("rms_norm", lambda ns, x, w: ns.nn.functional.norm.rms_norm(x, w),
         [_f32(3, 8), _f32(8)], grad=True),
]

LOGITS = _f32(5, 6, scale=2.0)
LAB = np.array([0, 3, 5, 1, 2], np.int64)
LAB_IGN = np.array([0, -100, 5, 1, -100], np.int64)
PROB = _pos(5, 6)
BIN = (_r.rand(5, 6) > 0.5).astype(np.float32)
SIGN = np.where(_r.rand(5) > 0.5, 1.0, -1.0).astype(np.float32)
# +-1 labels as integers where the losses only compare them
SIGN_INT = SIGN.astype(np.int64)
W6 = _pos(6)


def _lossf(name, *inputs, grad=True, label=None, tol=None, **kw):
    return fcase(name, list(inputs), grad=grad, tol=tol, label=label, **kw)


def _triplet_custom(ns, a, p, n):
    def dist(u, v):
        return ns.sum((u - v).abs(), axis=-1)
    return ns.nn.functional.triplet_margin_with_distance_loss(
        a, p, n, distance_function=dist, swap=True)


LOSS = [
    _lossf("cross_entropy", LOGITS, LAB),
    _lossf("softmax_with_cross_entropy", LOGITS, LAB[:, None]),
    _lossf("softmax_with_cross_entropy", LOGITS, LABELS_SOFT[[0, 1, 2, 3, 0]],
           soft_label=True, return_softmax=True,
           label="softmax_with_cross_entropy_soft"),
    _lossf("nll_loss", np.log(PROB), LAB),
    _lossf("nll_loss", np.log(PROB), LAB_IGN, W6, label="nll_loss_weight"),
    _lossf("nll_loss", np.log(PROB), LAB, reduction="none",
           label="nll_loss_none"),
    _lossf("mse_loss", PAIR_A, PAIR_B), _lossf("l1_loss", PAIR_A, PAIR_B),
    _lossf("smooth_l1_loss", PAIR_A, PAIR_B, delta=0.5),
    _lossf("square_error_cost", PAIR_A, PAIR_B),
    _lossf("binary_cross_entropy", PROB, BIN),
    _lossf("binary_cross_entropy", PROB, BIN, W6, reduction="sum",
           label="binary_cross_entropy_weight"),
    _lossf("binary_cross_entropy_with_logits", LOGITS, BIN),
    Case("bce_with_logits_pos_weight",
         lambda ns, z, y, w, pw: ns.nn.functional
         .binary_cross_entropy_with_logits(z, y, w, pos_weight=pw),
         [LOGITS, BIN, W6, _pos(6) + 0.5], grad=True),
    _lossf("kl_div", np.log(PROB), _pos(5, 6)),
    _lossf("kl_div", np.log(PROB), np.log(_pos(5, 6)), reduction="batchmean",
           log_target=True, label="kl_div_log_target"),
    _lossf("log_loss", _pos(5, 1), BIN[:, :1]),
    _lossf("hinge_embedding_loss", PAIR_A[:, 0], SIGN_INT[:4]),
    _lossf("margin_ranking_loss", PAIR_A[:, 0], PAIR_B[:, 0], SIGN[:4],
           margin=0.1),
    _lossf("cosine_embedding_loss", PAIR_A, PAIR_B, SIGN_INT[:4],
           margin=0.2),
    _lossf("triplet_margin_loss", PAIR_A, PAIR_B, _f32(4, 6), swap=True),
    _lossf("multi_label_soft_margin_loss", LOGITS, BIN),
    _lossf("multi_label_soft_margin_loss", LOGITS, BIN, _pos(5),
           reduction="none", label="multi_label_soft_margin_loss_weight"),
    _lossf("soft_margin_loss", PAIR_A, np.sign(PAIR_B)),
    _lossf("sigmoid_focal_loss", LOGITS, BIN),
    _lossf("sigmoid_focal_loss", LOGITS, BIN, np.float32([3.0]),
           reduction="mean", label="sigmoid_focal_loss_normalizer"),
    _lossf("dice_loss", np.exp(LOGITS) / np.exp(LOGITS).sum(-1, keepdims=True),
           LAB[:, None]),
    _lossf("npair_loss", PAIR_A, PAIR_B, np.array([1, 2, 1, 3], np.int64)),
    _lossf("poisson_nll_loss", PAIR_A, np.abs(PAIR_B)),
    _lossf("poisson_nll_loss", _pos(4, 6) + 0.5, np.abs(PAIR_B) * 3,
           log_input=False, full=True, label="poisson_nll_loss_full"),
    _lossf("gaussian_nll_loss", PAIR_A, PAIR_B, _pos(4, 6)),
    _lossf("gaussian_nll_loss", PAIR_A, PAIR_B, _pos(4, 6), full=True,
           reduction="sum", label="gaussian_nll_loss_full"),
    _lossf("multi_margin_loss", LOGITS, LAB),
    Case("multi_margin_loss_weight",
         lambda ns, x, y, w: ns.nn.functional.multi_margin_loss(
             x, y, p=2, margin=0.5, weight=w), [LOGITS, LAB, W6], grad=True),
    _lossf("triplet_margin_with_distance_loss", PAIR_A, PAIR_B, _f32(4, 6)),
    Case("triplet_margin_with_distance_loss_custom", _triplet_custom,
         [PAIR_A, PAIR_B, _f32(4, 6)], grad=True),
]

ATT_Q = _f32(2, 5, 2, 8)
ATT_K, ATT_V = _f32(2, 7, 2, 8), _f32(2, 7, 2, 8)
BOOL_MASK = _r.rand(2, 1, 5, 7) > 0.3
BOOL_MASK[..., 0] = True
ADD_MASK = np.where(_r.rand(2, 2, 5, 7) > 0.3, 0.0, -1e4).astype(np.float32)
FLASH_Q = _f32(1, 6, 2, 64, scale=0.3)
CU = np.array([0, 2, 6], np.int32)


def _unpadded(causal):
    def fn(ns, q, k, v, cu):
        return ns.nn.functional.flash_attn_unpadded(
            q, k, v, cu, cu, 4, 4, 0.125, causal=causal)[0]
    return fn


ATTENTION = [
    fcase("scaled_dot_product_attention", [ATT_Q, ATT_K, ATT_V]),
    fcase("scaled_dot_product_attention", [ATT_Q, ATT_K, ATT_V, BOOL_MASK],
          label="sdpa_bool_mask"),
    fcase("scaled_dot_product_attention", [ATT_Q, ATT_K, ATT_V, ADD_MASK],
          label="sdpa_additive_mask"),
    fcase("scaled_dot_product_attention", [ATT_Q, ATT_Q, ATT_Q],
          is_causal=True, label="sdpa_causal"),
    fcase("scaled_dot_product_attention", [ATT_Q, ATT_K, ATT_V],
          dropout_p=0.5, training=False, label="sdpa_dropout_eval"),
    Case("flash_attention", lambda ns, q: ns.nn.functional.flash_attention(
        q, q, q, causal=True)[0], [FLASH_Q], grad=True),
    Case("flash_attention_segment_ids",
         lambda ns, q, s: ns.nn.functional.flash_attention(
             q, q, q, causal=True, segment_ids=s)[0],
         [FLASH_Q, np.array([[0, 0, 1, 1, 1, 2]], np.int32)], grad=True),
    Case("flash_attn_unpadded", _unpadded(False), [FLASH_Q[0], FLASH_Q[0],
                                                   FLASH_Q[0], CU], grad=True),
    Case("flash_attn_unpadded_causal", _unpadded(True),
         [FLASH_Q[0], FLASH_Q[0], FLASH_Q[0], CU], grad=True),
]

# ---- the trouble spots ----

IMG_UP = _f32(1, 2, 3, 4)
IMG_DOWN = _f32(1, 2, 7, 9)
_INTERP = []
for _mode in ("nearest", "bilinear", "bicubic", "area"):
    for _ac in (False, True):
        for _tag, _img, _kw in (("up", IMG_UP, {"size": [5, 7]}),
                                ("down", IMG_DOWN, {"size": [3, 4]})):
            _INTERP.append(fcase(
                "interpolate", [_img], grad=_mode != "nearest",
                label=f"interpolate_{_mode}_{_tag}_ac{int(_ac)}", mode=_mode,
                align_corners=_ac, **_kw))
_INTERP += [
    fcase("interpolate", [_f32(1, 2, 5)], size=[8], mode="linear",
          data_format="NCW", label="interpolate_linear_1d"),
    fcase("interpolate", [np.moveaxis(IMG_UP, 1, -1).copy()],
          scale_factor=1.5, mode="bilinear", data_format="NHWC",
          label="interpolate_bilinear_nhwc_scale"),
    fcase("interpolate", [_f32(1, 1, 2, 3, 4)], size=[3, 5, 2],
          mode="trilinear", label="interpolate_trilinear"),
]

CTC_T, CTC_B, CTC_V = 6, 3, 5
CTC_LOGP = np.log(_pos(CTC_T, CTC_B, CTC_V) /
                  _pos(CTC_T, CTC_B, CTC_V).sum(-1, keepdims=True)) \
    .astype(np.float32)
# row 2 is infeasible: 4 labels with a repeat need 5 frames, it has 3
CTC_LABELS = np.array([[1, 2, 2, 0], [3, 1, 0, 0], [1, 1, 2, 3]], np.int32)
CTC_IN = np.array([6, 5, 3], np.int64)
# the infeasible row's forward variables sit near optax's log(0) of -1e5,
# where float32 steps by 2**-7: its gradient (the softmax of sums at that
# magnitude) agrees to ~1e-3 between two summation orders; the feasible
# rows, alone in `ctc_loss_sum`, hold the default tolerance
CTC_TOL = 5e-3
CTC_LL = np.array([3, 2, 4], np.int64)

RNNT_B, RNNT_T, RNNT_U, RNNT_V = 2, 4, 3, 5
RNNT_ACTS = _f32(RNNT_B, RNNT_T, RNNT_U + 1, RNNT_V)
RNNT_LABELS = np.array([[1, 2, 4], [3, 1, 0]], np.int32)

HS_X, HS_Y = _f32(4, 5), np.array([0, 3, 6, 2], np.int64)
HS_W, HS_B = _f32(6, 5), _f32(6, 1)
HS_TABLE = np.array([[0, 1, -1], [0, 2, 4], [1, 3, -1], [0, -1, -1]],
                    np.int64)
HS_CODE = np.array([[1, 0, -1], [0, 1, 1], [1, 1, -1], [0, -1, -1]],
                   np.int64)

COS = np.clip(_f32(4, 6, scale=0.4), -0.95, 0.95)

GT_IDS = _r.randint(0, 9, (4, 2, 3)).astype(np.int64)
GT_PARENTS = _r.randint(0, 3, (4, 2, 3)).astype(np.int64)

UNFOLD_IMG = _f32(2, 3, 6, 7)


def _ce(label, *inputs, **kw):
    return fcase("cross_entropy", list(inputs), label=f"cross_entropy_{label}",
                 **kw)


def _class_center(ns, lab):
    return ns.nn.functional.class_center_sample(lab, 20, 8)


TROUBLE = _INTERP + [
    fcase("gelu", [X * 3], label="gelu_exact"),
    fcase("gelu", [X * 3], approximate=True, label="gelu_tanh"),
    _ce("ignore_index", LOGITS, LAB_IGN),
    _ce("weight", LOGITS, LAB_IGN, W6),
    _ce("weight_sum", LOGITS, LAB, W6, reduction="sum"),
    _ce("none", LOGITS, LAB_IGN, reduction="none"),
    _ce("label_column", LOGITS, LAB[:, None]),
    _ce("soft_label", LOGITS, PROB / PROB.sum(-1, keepdims=True),
        soft_label=True),
    _ce("float_labels_of_logits_shape", LOGITS, LABELS_SOFT[[0, 1, 2, 3, 0]]),
    _ce("label_smoothing", LOGITS, LAB_IGN, label_smoothing=0.1),
    _ce("soft_smoothing", LOGITS, LABELS_SOFT[[0, 1, 2, 3, 0]],
        soft_label=True, label_smoothing=0.2),
    _ce("axis_1", _f32(2, 6, 3), np.array([[0, 5, 2], [1, 1, 3]], np.int64),
        axis=1),
    _ce("no_softmax", PROB, LAB, use_softmax=False),
    fcase("ctc_loss", [CTC_LOGP, CTC_LABELS, CTC_IN, CTC_LL],
          label="ctc_loss_infeasible_row", reduction="none", tol=CTC_TOL),
    fcase("ctc_loss", [CTC_LOGP, CTC_LABELS, CTC_IN, CTC_LL],
          label="ctc_loss_mean", blank=4, tol=CTC_TOL),
    fcase("ctc_loss", [CTC_LOGP[:, :2], CTC_LABELS[:2], CTC_IN[:2],
                       CTC_LL[:2]], label="ctc_loss_sum", reduction="sum"),
    fcase("rnnt_loss", [RNNT_ACTS, RNNT_LABELS, np.array([4, 3], np.int64),
                        np.array([3, 2], np.int64)]),
    fcase("rnnt_loss", [RNNT_ACTS, RNNT_LABELS, np.array([4, 4], np.int64),
                        np.array([3, 1], np.int64)], fastemit_lambda=0.0,
          reduction="none", blank=4, label="rnnt_loss_no_fastemit"),
    Case("hsigmoid_loss_default_tree",
         lambda ns, x, y, w, b: ns.nn.functional.hsigmoid_loss(x, y, 7, w, b),
         [HS_X, HS_Y, HS_W, HS_B], grad=True),
    Case("hsigmoid_loss_custom_tree",
         lambda ns, x, y, w, b, pt, pc: ns.nn.functional.hsigmoid_loss(
             x, y, 7, w, b, pt, pc),
         [HS_X, HS_Y, HS_W, HS_B, HS_TABLE, HS_CODE], grad=True),
    fcase("margin_cross_entropy", [COS, np.array([0, 5, 2, 3], np.int64)]),
    fcase("margin_cross_entropy", [COS, np.array([1, 1, 4, 0], np.int64)],
          margin1=0.9, margin2=0.2, margin3=0.1, scale=16.0,
          return_softmax=True, reduction=None,
          label="margin_cross_entropy_softmax"),
    Case("class_center_sample", _class_center,
         [np.array([3, 7, 3, 15, 0], np.int64)]),
    fcase("unfold", [UNFOLD_IMG], kernel_sizes=[2, 3], strides=[2, 1],
          paddings=1, dilations=[1, 2], label="unfold_strided"),
    fcase("unfold", [UNFOLD_IMG], kernel_sizes=3, paddings=[1, 2, 1, 2],
          label="unfold_paddings4"),
    fcase("fold", [_f32(2, 18, 18)], output_sizes=[5, 6], kernel_sizes=3,
          strides=1, paddings=[0, 1], dilations=[1, 1],
          label="fold_padded"),
    fcase("fold", [_f32(1, 8, 16)], output_sizes=[6, 7], kernel_sizes=2,
          strides=2, paddings=1, dilations=1, label="fold_strided"),
    fcase("gather_tree", [GT_IDS, GT_PARENTS], grad=False),
]

TABLES = {"activation": ACTIVATION, "common": COMMON, "input": INPUT,
          "norm": NORM, "loss": LOSS, "attention": ATTENTION,
          "trouble": TROUBLE}
ALL = [c for t in TABLES.values() for c in t]

# ---- the functions that draw: each package against itself ----

def dropout_stats(ns, p=0.5):
    """(kept share, mean) of `dropout` over a 100 x 100 block of ones, and
    whether the eval pass is the input itself."""
    x = ns.to_tensor(np.ones((100, 100), np.float32))
    y = ns.nn.functional.dropout(x, p, training=True).numpy()
    ev = ns.nn.functional.dropout(x, p, training=False)
    return float((y != 0).mean()), float(y.mean()), ev is x


def seeded_repeats(ns, fn):
    """fn(ns) twice under one seed, once under another: (first, second,
    third) as numpy."""
    outs = []
    for s in (5, 5, 6):
        ns.seed(s)
        outs.append(np.asarray(fn(ns).numpy()))
    return outs


_ALPHA_X, _RRELU_X, _GUMBEL_X = _f32(8, 16), -np.abs(_f32(8, 16)), \
    _f32(8, 16)

RANDOM = {
    "dropout": lambda ns: ns.nn.functional.dropout(
        ns.to_tensor(np.ones((8, 16), np.float32)), 0.5),
    "dropout_axis": lambda ns: ns.nn.functional.dropout(
        ns.to_tensor(np.ones((4, 6, 3), np.float32)), 0.5, axis=[0, 2]),
    "dropout2d": lambda ns: ns.nn.functional.dropout2d(
        ns.to_tensor(np.ones((2, 6, 3, 3), np.float32)), 0.5),
    "alpha_dropout": lambda ns: ns.nn.functional.alpha_dropout(
        ns.to_tensor(_ALPHA_X), 0.3),
    "rrelu": lambda ns: ns.nn.functional.rrelu(
        ns.to_tensor(_RRELU_X), training=True),
    "gumbel_softmax": lambda ns: ns.nn.functional.gumbel_softmax(
        ns.to_tensor(_GUMBEL_X)),
    "sdpa_dropout": lambda ns: ns.nn.functional.scaled_dot_product_attention(
        *(ns.to_tensor(a) for a in (ATT_Q, ATT_K, ATT_V)), dropout_p=0.5),
}


def carry(ref_layer, port_layer):
    """Copy the reference Layer's parameters and buffers (persistable or
    not, random draws such as SpectralNorm's u and v included) into the
    port's twin, by structured name, through the port's `set_state_dict`."""
    state = {k: np.asarray(v.numpy()) for k, v in ref_layer.state_dict().items()}
    missing, unexpected = port_layer.set_state_dict(state)
    assert not missing and not unexpected, (missing, unexpected)
    own = dict(port_layer.named_buffers())
    for k, v in ref_layer.named_buffers():
        if k not in state:
            own[k].set_value(np.asarray(v.numpy()))
    return port_layer
