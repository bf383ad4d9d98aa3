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
LOSS, ATTENTION, CONV, POOL and VISION (vision and the sparse ops) hold
every public function of the functional modules (CONV: strides,
dilations, groups, asymmetric and string paddings, channel-last and the
transposes; POOL: ceil_mode, wide paddings, the divisors, `return_mask`,
the adaptive bins and the unpools); TROUBLE the spots where torch's defaults and the reference's
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


# ---- conv, pooling, vision and the sparse ops (their own stream, so the
# tables above keep their data) ----

_q = np.random.RandomState(27)


def _g32(*shape, scale=1.0):
    return (_q.randn(*shape) * scale).astype(np.float32)


def _nhwc(a):
    return np.moveaxis(a, 1, -1).copy()


C1, C2, C3 = _g32(2, 4, 9), _g32(2, 4, 7, 8), _g32(1, 2, 5, 6, 4)
W1, W2, W3 = _g32(6, 4, 3), _g32(6, 4, 3, 3), _g32(3, 2, 2, 3, 2)
B6, B3 = _g32(6), _g32(3)

CONV = [
    fcase("conv1d", [C1, W1, B6], stride=2, padding=1),
    fcase("conv1d", [C1, W1], padding="SAME", dilation=2,
          label="conv1d_same_dilated"),
    fcase("conv1d", [C1, _g32(6, 2, 3), B6], padding=[1, 2], groups=2,
          label="conv1d_groups_asym"),
    fcase("conv1d", [_nhwc(C1), W1, B6], stride=2, padding="valid",
          data_format="NLC", label="conv1d_nlc"),
    fcase("conv2d", [C2, W2, B6], stride=[2, 1], padding=[1, 2, 0, 1],
          dilation=[1, 2], label="conv2d_asym_dilated"),
    fcase("conv2d", [C2, _g32(6, 2, 3, 3)], padding=1, groups=2,
          label="conv2d_groups"),
    fcase("conv2d", [C2, W2, B6], stride=2, padding="SAME",
          label="conv2d_same_stride2"),
    fcase("conv2d", [C2, W2], stride=3, padding="VALID",
          label="conv2d_valid"),
    fcase("conv2d", [_nhwc(C2), W2, B6], stride=2, padding=[1, 0],
          data_format="NHWC", label="conv2d_nhwc"),
    fcase("conv3d", [C3, W3, B3], stride=2, padding=1),
    fcase("conv3d", [C3, W3], padding="SAME", dilation=[1, 2, 1],
          label="conv3d_same"),
    fcase("conv3d", [np.moveaxis(C3, 1, -1).copy(), W3, B3],
          padding=[0, 1, 1, 0, 1, 1], data_format="NDHWC",
          label="conv3d_ndhwc_asym"),
    # transposes: the reference runs them where in / groups == out / groups
    fcase("conv1d_transpose", [C1[:, :, :5], _g32(4, 4, 3), _g32(4)],
          stride=2, padding=1, output_padding=1),
    fcase("conv1d_transpose", [C1[:, :, :5], _g32(4, 2, 3)], groups=2,
          stride=3, padding="SAME", label="conv1d_transpose_groups_same"),
    fcase("conv1d_transpose", [_nhwc(C1[:, :, :5]), _g32(4, 4, 3)],
          stride=2, padding="VALID", dilation=2, data_format="NLC",
          label="conv1d_transpose_nlc_valid"),
    fcase("conv2d_transpose", [C2[:, :, :4, :5], _g32(4, 4, 3, 3),
                               _g32(4)], stride=2, padding=[1, 0],
          dilation=2, output_padding=1),
    fcase("conv2d_transpose", [C2[:, :, :4, :5], _g32(4, 4, 3, 3)],
          stride=[2, 3], padding=[1, 2, 0, 1], output_size=[99, 99],
          label="conv2d_transpose_asym_output_size_ignored"),
    fcase("conv2d_transpose", [C2[:, :, :4, :5], _g32(4, 2, 2, 3),
                               _g32(4)], stride=2, groups=2,
          label="conv2d_transpose_groups"),
    fcase("conv2d_transpose", [C2[:, :, :4, :5], _g32(4, 4, 3, 3)],
          stride=3, padding="SAME", label="conv2d_transpose_same"),
    fcase("conv2d_transpose", [C2[:, :, :4, :5], _g32(4, 4, 3, 3)],
          stride=2, padding="VALID", dilation=2,
          label="conv2d_transpose_valid_dilated"),
    fcase("conv2d_transpose", [_nhwc(C2[:, :, :4, :5]), _g32(4, 4, 3, 3),
                               _g32(4)], stride=2, padding=1,
          data_format="NHWC", label="conv2d_transpose_nhwc"),
    fcase("conv3d_transpose", [C3[:, :, :3, :4, :3], _g32(2, 2, 2, 3, 2),
                               _g32(2)], stride=2, padding=1),
    fcase("conv3d_transpose", [np.moveaxis(C3[:, :, :3, :4, :3], 1,
                                           -1).copy(), _g32(2, 2, 2, 2, 2)],
          stride=2, padding="SAME", data_format="NDHWC",
          label="conv3d_transpose_ndhwc_same"),
]

P1, P2, P3 = _g32(2, 3, 9), _g32(2, 3, 7, 8), _g32(1, 2, 5, 6, 4)
P2_INT = _q.randint(-50, 50, (2, 3, 7, 8)).astype(np.int32)
# unpool indices: distinct flat positions in each (n, c) plane, one of
# them negative (from the end) and one past the end (dropped)
UNPOOL_2D = np.stack([np.stack([_q.permutation(12)[:6] for _ in range(3)])
                      for _ in range(2)]).reshape(2, 3, 2, 3).astype(np.int32)
UNPOOL_2D[0, 0, 0, 0], UNPOOL_2D[1, 2, 1, 2] = -1, 40
UNPOOL_1D = np.stack([np.stack([_q.permutation(10)[:4] for _ in range(3)])
                      for _ in range(2)]).astype(np.int32)
UNPOOL_3D = np.stack([_q.permutation(64)[:8] for _ in range(2)]) \
    .reshape(1, 2, 2, 2, 2).astype(np.int32)


def _pool_then_unpool(ns, x):
    f = ns.nn.functional
    out, mask = f.max_pool2d(x, 2, return_mask=True)
    return f.max_unpool2d(out, mask, 2)


POOL = [
    fcase("max_pool1d", [P1], kernel_size=3, stride=2, padding=1),
    fcase("max_pool1d", [P1], kernel_size=2, ceil_mode=True,
          return_mask=True, label="max_pool1d_ceil_mask"),
    fcase("max_pool1d", [_nhwc(P1)], kernel_size=3, padding=2,
          data_format="NLC", label="max_pool1d_nlc_wide_pad"),
    fcase("max_pool2d", [P2], kernel_size=3, stride=2, padding=1),
    fcase("max_pool2d", [P2], kernel_size=2, ceil_mode=True,
          label="max_pool2d_ceil"),
    fcase("max_pool2d", [P2], kernel_size=[3, 2], stride=[2, 3],
          padding=[1, 2, 0, 1], ceil_mode=True, label="max_pool2d_asym_ceil"),
    fcase("max_pool2d", [P2], kernel_size=3, padding=2,
          label="max_pool2d_wide_pad"),
    fcase("max_pool2d", [P2], kernel_size=3, stride=2, padding="SAME",
          label="max_pool2d_same"),
    fcase("max_pool2d", [P2], kernel_size=3, stride=2, padding="valid",
          label="max_pool2d_valid"),
    fcase("max_pool2d", [_nhwc(P2)], kernel_size=2, stride=1, padding=1,
          data_format="NHWC", label="max_pool2d_nhwc"),
    fcase("max_pool2d", [P2_INT], grad=False, kernel_size=3, stride=2,
          padding=1, label="max_pool2d_int"),
    fcase("max_pool2d", [P2], kernel_size=3, stride=2, padding=1,
          return_mask=True, label="max_pool2d_mask_padded"),
    fcase("max_pool2d", [P2], kernel_size=2, return_mask=True,
          label="max_pool2d_mask"),
    fcase("max_pool3d", [P3], kernel_size=2, stride=2, ceil_mode=True),
    fcase("max_pool3d", [P3], kernel_size=3, stride=2, padding=1,
          return_mask=True, label="max_pool3d_mask"),
    fcase("max_pool3d", [np.moveaxis(P3, 1, -1).copy()], kernel_size=2,
          padding=[0, 1, 1, 0, 0, 1], data_format="NDHWC",
          label="max_pool3d_ndhwc_asym"),
    fcase("avg_pool1d", [P1], kernel_size=3, stride=2, padding=1),
    fcase("avg_pool1d", [P1], kernel_size=2, ceil_mode=True, exclusive=False,
          label="avg_pool1d_ceil_inclusive"),
    fcase("avg_pool1d", [_nhwc(P1)], kernel_size=3, padding=1,
          data_format="NLC", label="avg_pool1d_nlc"),
    fcase("avg_pool2d", [P2], kernel_size=3, stride=2, padding=1),
    fcase("avg_pool2d", [P2], kernel_size=3, stride=2, padding=1,
          exclusive=False, label="avg_pool2d_inclusive"),
    fcase("avg_pool2d", [P2], kernel_size=2, ceil_mode=True, exclusive=False,
          label="avg_pool2d_ceil_inclusive"),
    fcase("avg_pool2d", [P2], kernel_size=2, ceil_mode=True,
          label="avg_pool2d_ceil_exclusive"),
    fcase("avg_pool2d", [P2], kernel_size=3, padding=1, divisor_override=5,
          label="avg_pool2d_divisor"),
    fcase("avg_pool2d", [P2], kernel_size=3, stride=2, padding="SAME",
          exclusive=False, label="avg_pool2d_same_counts"),
    fcase("avg_pool2d", [P2], kernel_size=3, padding=2, exclusive=False,
          label="avg_pool2d_wide_pad"),
    fcase("avg_pool2d", [_nhwc(P2)], kernel_size=[2, 3], stride=2,
          padding=[1, 0, 1, 1], data_format="NHWC",
          label="avg_pool2d_nhwc_asym"),
    fcase("avg_pool3d", [P3], kernel_size=2, padding=1),
    fcase("avg_pool3d", [P3], kernel_size=3, stride=2, ceil_mode=True,
          exclusive=False, divisor_override=4, label="avg_pool3d_ceil_div"),
    fcase("adaptive_avg_pool1d", [P1], output_size=3),
    fcase("adaptive_avg_pool1d", [P1], output_size=4,
          label="adaptive_avg_pool1d_uneven"),
    fcase("adaptive_avg_pool2d", [P2], output_size=[7, 4]),
    fcase("adaptive_avg_pool2d", [P2], output_size=3,
          label="adaptive_avg_pool2d_uneven"),
    fcase("adaptive_avg_pool2d", [_nhwc(P2)], output_size=[2, 3],
          data_format="NHWC", label="adaptive_avg_pool2d_nhwc"),
    fcase("adaptive_avg_pool3d", [P3], output_size=[2, 3, 3]),
    fcase("adaptive_max_pool1d", [P1], output_size=4, return_mask=True),
    fcase("adaptive_max_pool2d", [P2], output_size=[3, 4]),
    fcase("adaptive_max_pool2d", [P2], output_size=2, return_mask=True,
          label="adaptive_max_pool2d_mask"),
    fcase("adaptive_max_pool3d", [P3], output_size=[5, 2, 3]),
    fcase("max_unpool1d", [_g32(2, 3, 4), UNPOOL_1D], kernel_size=2,
          stride=2, padding=[0]),
    fcase("max_unpool2d", [_g32(2, 3, 2, 3), UNPOOL_2D], kernel_size=2),
    fcase("max_unpool2d", [_g32(2, 3, 2, 3), UNPOOL_2D], kernel_size=3,
          stride=2, padding=1, output_size=[2, 3, 3, 5],
          label="max_unpool2d_output_size"),
    Case("max_unpool2d_of_max_pool2d_mask", _pool_then_unpool, [P2[..., :6]],
         grad=True),
    fcase("max_unpool3d", [_g32(1, 2, 2, 2, 2), UNPOOL_3D], kernel_size=2),
]

GRID = np.clip(_g32(2, 3, 4, 2, scale=0.7), -1.2, 1.2)
THETA = _g32(2, 2, 3, scale=0.5)
SM_MASK = np.where(_q.rand(2, 1, 4, 4) > 0.3, 0.0, -1e4).astype(np.float32)
SA_Q, SA_K, SA_V = _g32(1, 2, 4, 8), _g32(1, 2, 4, 8), _g32(1, 2, 4, 8)
# head 0: rows of 2, 1, 0 (empty) and 3 columns; head 1: 1 entry a row
SA_OFF = np.array([[[0, 2, 3, 3, 6], [0, 1, 2, 3, 4]]], np.int32)
SA_COLS = np.array([[[0, 1, 1, 0, 2, 3], [0, 1, 2, 3, 0, 0]]], np.int32)

VISION = [
    fcase("pixel_shuffle", [_g32(2, 8, 2, 3)], upscale_factor=2),
    fcase("pixel_shuffle", [_g32(2, 2, 3, 9)], upscale_factor=3,
          data_format="NHWC", label="pixel_shuffle_nhwc"),
    fcase("pixel_unshuffle", [_g32(2, 2, 4, 6)], downscale_factor=2),
    fcase("pixel_unshuffle", [_g32(2, 4, 6, 3)], downscale_factor=2,
          data_format="NHWC", label="pixel_unshuffle_nhwc"),
    fcase("channel_shuffle", [_g32(2, 6, 2, 3)], groups=3),
    fcase("channel_shuffle", [_g32(2, 2, 3, 6)], groups=2,
          data_format="NHWC", label="channel_shuffle_nhwc"),
    fcase("affine_grid", [THETA], out_shape=[2, 3, 4, 5]),
    fcase("affine_grid", [THETA], out_shape=[2, 3, 3, 4],
          align_corners=False, label="affine_grid_half_pixel"),
] + [
    fcase("grid_sample", [_g32(2, 3, 5, 6), GRID], mode=mode,
          padding_mode=pm, align_corners=ac,
          label=f"grid_sample_{mode}_{pm}_ac{int(ac)}")
    for mode in ("bilinear", "nearest")
    for pm in ("zeros", "border", "reflection") for ac in (True, False)
] + [
    fcase("softmax_mask_fuse", [_g32(2, 2, 4, 4), SM_MASK]),
    fcase("softmax_mask_fuse_upper_triangle", [_g32(2, 2, 5, 5)]),
    fcase("sparse_attention", [SA_Q, SA_K, SA_V, SA_OFF, SA_COLS]),
]

# ---- beam decoding over a GRUCell (not in TABLES: its twin and its card
# test live in tests/test_torch_nn_rnn.py and tests/test_torch_nn_cuda.py)

DEC_B, DEC_W, DEC_V, DEC_D, DEC_END, DEC_STEPS = 2, 3, 6, 4, 2, 7


def decode_weights(rng, B=DEC_B, V=DEC_V, D=DEC_D, tie=True):
    """Embedding [V, D], GRUCell(D, V) weights and h0 [B, V].  With `tie`,
    hidden units 2 and 3 are identical (and 2 and 3 of h0), so that tokens
    2 (the end token) and 3 tie at every step and the lower-index rule
    decides between them."""
    emb = rng.randn(V, D).astype(np.float32)
    wi = rng.randn(3 * V, D).astype(np.float32)
    wh = rng.randn(3 * V, V).astype(np.float32) * 0.5
    bi = rng.randn(3 * V).astype(np.float32) * 0.1
    bh = rng.randn(3 * V).astype(np.float32) * 0.1
    h0 = rng.randn(B, V).astype(np.float32) * 0.5
    if tie:
        for g in range(3):
            for a in (wi, wh, bi, bh):
                a[g * V + 3] = a[g * V + 2]
        bi[2 * V + 2] = bi[2 * V + 3] = 1.5      # keep 2 and 3 likely
        h0[:, 3] = h0[:, 2]
    return [emb, wi, wh, bi, bh, h0]


def decode_layers(ns, emb_w, wi, wh, bi, bh):
    V, D = emb_w.shape
    cell = ns.nn.GRUCell(D, V)
    emb = ns.nn.Embedding(V, D)
    for p, v in ((emb.weight, emb_w), (cell.weight_ih, wi),
                 (cell.weight_hh, wh), (cell.bias_ih, bi),
                 (cell.bias_hh, bh)):
        p.set_value(v)
    return cell, emb


def beam_decode(ns, emb_w, wi, wh, bi, bh, h0, cell_fn=None,
                decoder=None, beam=DEC_W, steps=DEC_STEPS):
    """`BeamSearchDecoder` (or the `decoder` class given) +
    `dynamic_decode(return_length=True)`: (tokens [B, T, W], final hidden
    [B * W, V], beam log-probs [B, W], finished [B, W], lengths [B, W])."""
    cell, emb = decode_layers(ns, emb_w, wi, wh, bi, bh)
    nn = ns.nn
    dec = (decoder or nn.BeamSearchDecoder)(
        cell_fn or cell, start_token=0, end_token=DEC_END, beam_size=beam,
        embedding_fn=emb)
    init = nn.BeamSearchDecoder.tile_beam_merge_with_batch(h0, beam)
    out, (h, lp, fin), lens = nn.dynamic_decode(
        dec, init, max_step_num=steps, return_length=True)
    return out, h, lp, fin, lens


DECODE = [Case("dynamic_decode_beam", beam_decode,
               decode_weights(np.random.RandomState(31)))]

TABLES = {"activation": ACTIVATION, "common": COMMON, "input": INPUT,
          "norm": NORM, "loss": LOSS, "attention": ATTENTION,
          "trouble": TROUBLE, "conv": CONV, "pool": POOL,
          "vision": VISION}
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
