"""Encrypted CNN inference: convolutions as structured plaintext matrices.

A convolutional network over an encrypted image compiles to the existing
encrypted-MLP machinery (models/mlp.py): a conv layer is a (sparse,
Toeplitz-structured) plaintext matrix acting on the flattened image slots,
average pooling is another, and adjacent linear stages FUSE by plain matrix
product before encoding — so a conv+pool+activation+dense CryptoNets-style
network costs exactly one BSGS product per activation boundary, the same
shape Gilad-Bachrach et al. evaluate. Weights are cleartext, activations
encrypted (the standard encrypted-inference deployment). The layers' plans
are built from their blocks (models/mlp.py), never from a slots x slots
matrix.

Layout: channels-major flattening — slot index c*H*W + y*W + x. All stage
output dims must fit the slot count. A copy of gpufhe_tpu/models/cnn.py.
"""

from __future__ import annotations

import numpy as np

from gpufhe_tpu_torch.models.mlp import EncryptedMLP, mlp_rotations  # noqa: F401


def conv2d_matrix(
    kernels: np.ndarray, in_shape: tuple[int, int], stride: int = 1
) -> np.ndarray:
    """kernels: [out_ch, in_ch, kh, kw] (valid padding) ->
    [(out_ch * H_out * W_out), (in_ch * H * W)] matrix."""
    oc, ic, kh, kw = kernels.shape
    h, w = in_shape
    ho = (h - kh) // stride + 1
    wo = (w - kw) // stride + 1
    m = np.zeros((oc * ho * wo, ic * h * w))
    for o in range(oc):
        for yo in range(ho):
            for xo in range(wo):
                row = (o * ho + yo) * wo + xo
                for i in range(ic):
                    for dy in range(kh):
                        for dx in range(kw):
                            y = yo * stride + dy
                            x = xo * stride + dx
                            m[row, (i * h + y) * w + x] = kernels[o, i, dy, dx]
    return m


def avgpool_matrix(
    channels: int, in_shape: tuple[int, int], pool: int = 2
) -> np.ndarray:
    """Non-overlapping average pooling as a matrix (per channel)."""
    h, w = in_shape
    ho, wo = h // pool, w // pool
    m = np.zeros((channels * ho * wo, channels * h * w))
    inv = 1.0 / (pool * pool)
    for c in range(channels):
        for yo in range(ho):
            for xo in range(wo):
                row = (c * ho + yo) * wo + xo
                for dy in range(pool):
                    for dx in range(pool):
                        y, x = yo * pool + dy, xo * pool + dx
                        m[row, (c * h + y) * w + x] = inv
    return m


def compile_cnn(
    conv_kernels: np.ndarray,
    conv_bias: np.ndarray,
    in_shape: tuple[int, int],
    dense_w: np.ndarray,
    dense_b: np.ndarray,
    pool: int = 2,
    stride: int = 1,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """conv -> avgpool -> square -> dense, as two fused MLP layers.

    The pooling matrix composes with the conv matrix (and the pooled bias)
    BEFORE encoding, so the encrypted pipeline runs:
        layer 1: (P @ C) x + P @ (bias per output pixel)   [then square]
        layer 2: dense_w x + dense_b                        [logits]
    """
    oc, ic, kh, kw = conv_kernels.shape
    h, w = in_shape
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    c_mat = conv2d_matrix(conv_kernels, in_shape, stride)
    p_mat = avgpool_matrix(oc, (ho, wo), pool)
    b_pix = np.repeat(conv_bias, ho * wo)  # per-output-pixel conv bias
    layer1 = (p_mat @ c_mat, p_mat @ b_pix)
    assert dense_w.shape[1] == p_mat.shape[0], (dense_w.shape, p_mat.shape)
    return [layer1, (dense_w, dense_b)]


class EncryptedCNN:
    """conv -> pool -> square -> dense on an encrypted flattened image.

    A thin compiler over EncryptedMLP; see compile_cnn for the fusion."""

    def __init__(self, be, conv_kernels, conv_bias, in_shape, dense_w,
                 dense_b, pool: int = 2, stride: int = 1, refresh=None):
        self.in_shape = in_shape
        self.in_ch = conv_kernels.shape[1]
        layers = compile_cnn(
            conv_kernels, conv_bias, in_shape, dense_w, dense_b, pool, stride
        )
        self.mlp = EncryptedMLP(be, layers, activation="square", refresh=refresh)

    def __call__(self, ct_image):
        """ct_image: encrypted flattened image (channels-major slots)."""
        return self.mlp(ct_image)

    def reference(self, image: np.ndarray) -> np.ndarray:
        """Cleartext forward pass on image[in_ch*H*W] (parity oracle)."""
        return self.mlp.reference(image)
