"""The MNIST inference's control: the network's forward computed one
precision below what the deployment holds, in the library's place, read by
the numbers the check compares (circuits/mlp_forward.py judge).

CKKS computes in fixed point at Delta = 2^28, and what the forward holds of
its logits is set by the noise each rotation, product and rescale adds: on
an H100 its widest gap reads 1.0e-4 to 3.4e-4 (32 seeds), about 12 bits of
logits near 1. bfloat16, with 8 bits, is the format below it, as the
logistic-regression cell's control at the same Delta takes
(control_logreg.py); float16, with 11, reads 7.9e-4 to 4.2e-3 over 54
seeds, under three times the forward's widest, and so cannot bound it
apart. Every value is held in the format: the image, the weights and
biases, each layer's product and sum and each square (torch's CPU kernels).
Its logits are the control's output, and every other slot is an exact
zero, so it reads the same as max_err (over all slots) and as mean_err
(over the logits).
"""

from __future__ import annotations

import numpy as np
import torch

from fhebench.reference import mlp

DTYPE = torch.bfloat16


def reading(layers: list, xs: np.ndarray, dtype=DTYPE) -> float:
    """The widest gap of the forward in dtype to the float64 forward over
    the given images."""
    return max(float(np.abs(mlp.forward(layers, x, dtype) - mlp.forward(layers, x)).max())
               for x in xs)
