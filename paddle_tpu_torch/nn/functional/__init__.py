"""`paddle.nn.functional` of the port: the activation, common, conv,
input, extension, loss, norm, pooling, distance, attention,
flash-attention, vision and sparse-op functions (reference
`paddle_tpu/nn/functional/__init__.py`)."""
from .activation import (celu, elu, gelu, glu, gumbel_softmax, hardshrink,  # noqa
                         hardsigmoid, hardswish, hardtanh, leaky_relu, log_sigmoid,
                         log_softmax, maxout, mish, prelu, relu, relu6, relu_, rrelu,
                         selu, sigmoid, silu, softmax, softmax_, softplus, softshrink,
                         softsign, swish, tanh, tanh_, tanhshrink, thresholded_relu,
                         elu_, hardtanh_, leaky_relu_, thresholded_relu_)
from .common import (alpha_dropout, bilinear, cosine_similarity, dropout, dropout2d,  # noqa
                     dropout3d, interpolate, label_smooth, linear, one_hot, pad,
                     unfold, fold, upsample, zeropad2d)
from .conv import conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d, conv3d_transpose  # noqa
from .extension import (diag_embed, gather_tree, sequence_mask, temporal_shift)  # noqa
from .input import embedding, one_hot as _one_hot_input  # noqa
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,  # noqa
                   cross_entropy, ctc_loss, dice_loss, hinge_embedding_loss, kl_div,
                   l1_loss, log_loss, margin_ranking_loss, mse_loss, nll_loss,
                   npair_loss, poisson_nll_loss, sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost, triplet_margin_loss,
                   cosine_embedding_loss, multi_label_soft_margin_loss, soft_margin_loss,
                   gaussian_nll_loss, hsigmoid_loss, multi_margin_loss,
                   triplet_margin_with_distance_loss, margin_cross_entropy,
                   rnnt_loss, class_center_sample)
from .norm import batch_norm, group_norm, instance_norm, layer_norm, local_response_norm, normalize  # noqa
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,  # noqa
                      adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
                      avg_pool1d, avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d, max_unpool1d, max_unpool2d, max_unpool3d)
from .attention import scaled_dot_product_attention  # noqa
from .flash_attention import flash_attention, flash_attn_unpadded  # noqa
from .vision import affine_grid, grid_sample, pixel_shuffle, pixel_unshuffle, channel_shuffle  # noqa
from .distance import pairwise_distance  # noqa
from .sparse_ops import (softmax_mask_fuse, softmax_mask_fuse_upper_triangle,  # noqa
                         sparse_attention)
