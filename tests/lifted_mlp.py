"""The reference's EncryptedMLP (gpufhe_tpu/models/mlp.py) with the port's
lift (gpufhe_tpu_torch/models/mlp.py _lift_of): where the port lifts a
forward, the input times `lift` (a plaintext product, no rescale) and each
layer's diagonals at Delta / sqrt(lift); the rest is the reference's own
code. The port's square networks are held == this, limb for limb
(tests/test_torch_models.py, tests/test_torch_cli.py)."""

import math

import numpy as np

from gpufhe_tpu.ciphertext.linalg import BsgsPlan
from gpufhe_tpu.models import mlp as rmlp
from gpufhe_tpu_torch.models import mlp as pmlp


class LiftedMLP(rmlp.EncryptedMLP):
    def __init__(self, be, layers, *args, **kwargs):
        super().__init__(be, layers, *args, **kwargs)
        # the port's rule: a square network without a refresh
        self._lifts = self.act_ref is not None and self.refresh is None
        self.lift = 1

    def _plan(self, i, level):
        if (i, level) not in self._plans:
            slots = self.be.params.slots
            self._plans[(i, level)] = BsgsPlan(
                self.be, rmlp._embed(self.layers[i][0], slots), None, level,
                self.be.params.scale / math.sqrt(self.lift))
        return self._plans[(i, level)]

    def __call__(self, ct):
        be = self.be
        self.lift = 1
        if self._lifts:
            self.lift = pmlp._lift_of(be.params.scale, be.level(ct), self.levels_used)
        if self.lift > 1:
            ones = np.ones(be.params.slots, dtype=np.complex128)
            ct = be.mul_plain(ct, be.encode_slots(ones, float(self.lift), be.level(ct)))
        return super().__call__(ct)
