"""The logistic-regression step's control: the plain update computed one
precision below what the deployment holds, in the library's place, read by
the numbers the check compares (circuits/logreg_step.py judge).

CKKS computes in fixed point, and what the step holds of its update is set
by the noise each operation adds: at Delta = 2^28 and N = 2^16 the update
(about 0.04 a weight) comes out within about 1e-5 of the float64 update of
its inputs as a weight's slots average it (`mean_err`), 11 or more bits of
it. bfloat16, with 8 bits, is the nearest float format below; float16, with
11, reads 6e-6 to 3.8e-5 on the pool's entries (6 seeds), as close as the
program, and so cannot bound it. Each value is held in the format: the
inputs, X w, the sigmoid, p - y and the update (torch's CPU kernels).
"""

from __future__ import annotations

import numpy as np
import torch

from fhebench.reference import logreg

DTYPE = torch.bfloat16


def update(w, x, y, lr: float, dtype=DTYPE) -> np.ndarray:
    """The step's change of w, -(lr/m) X^T (p - y), with every value in dtype."""
    xt, yt, wt = (torch.as_tensor(np.asarray(v, np.float64)).to(dtype) for v in (x, y, w))
    z = xt @ wt
    p = 0.5 + logreg.C1 * z + logreg.C3 * z**3
    return (-(lr / xt.shape[0]) * (xt.T @ (p - yt))).double().numpy()


def reading(x, y, lr: float, entries: int) -> float:
    """The control's widest gap to the float64 update over the first
    `entries` weight sets of the leg from 0. Its update is one value a
    weight, so it reads the same as max_err and as mean_err."""
    ws = logreg.leg(x, y, lr, entries)
    return max(float(np.abs(update(ws[k], x, y, lr) - logreg.update(ws[k], x, y, lr)).max())
               for k in range(entries))
