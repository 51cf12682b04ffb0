"""gpufhe_tpu_torch — the PyTorch + CUDA port of gpufhe_tpu (CKKS, BGV, BFV).

The module tree mirrors gpufhe_tpu's, so each module's counterpart has the
same path under the other package:

  params/      CKKSParams (plain_modulus > 0 for BGV / BFV), presets,
               NTT-friendly prime generation
  golden/      the golden model in numpy, the oracle independent of the
               kernels: host sampling (numpy Generators), encoder, keygen,
               every CKKS, BGV and BFV ciphertext op, the exact NTT (in C
               by golden/native.py), RNS helpers, the known-answer vectors
  ops/         int64 modular arithmetic, device tables, the negacyclic NTT
               (kernel K1, csrc/ntt.cu), the RNS base conversion (kernel K3,
               csrc/convert.cu), the key-switch MAC (K4, csrc/mac.cu) and
               the rescale (csrc/rescale.cu)
  primitives/  ModUp / ModDown (t-corrected for BGV) / rescale / BGV
               ModSwitch, hybrid key switching
  keys/        Montgomery-form device keys and the key chest
  encoding/    canonical-embedding encode/decode, plaintext upload
  ciphertext/  encrypt / decrypt, tensor, relinearize, rescale, ct_mul_full,
               rotations, the fused diagonal fan and ModRaise (ct.py); the
               DeviceBackend surface, BSGS and factored-FFT linear maps,
               the Chebyshev evaluator and the CKKS Bootstrapper; BGV
               (bgv.py) and BFV (bfv.py: the BEHZ multiply, scheme
               switching) and their linalg backends
  models/      the encrypted models (MLP, CNN, logistic regression and its
               trainer, PIR, attention, the transformer block)
  utils/       serialization (the reference's npz format), security
               estimates, noise reports, profiling, kernel bounds
  api          Session and ThresholdSession, the facade over all of it
  cli          python -m gpufhe_tpu_torch.cli
  bench        the headline lines on the card (cli bench; the root bench.py's
               counterpart)
  interop      carrying gpufhe_tpu state (numpy arrays) into this package

Residues are int64 tensors holding canonical values in [0, q) for primes
q < 2^30, so every product of two residues fits in 60 bits. Entry points
take an explicit ``device`` (default ``"cuda"``). A CPU tensor runs each
kernel's plain PyTorch version; a CUDA tensor launches the hand-written
kernel. This package imports neither jax nor gpufhe_tpu.
"""

__version__ = "0.1.0"

from gpufhe_tpu_torch.params.params import CKKSParams, make_context  # noqa: F401
from gpufhe_tpu_torch.api import Session  # noqa: F401
