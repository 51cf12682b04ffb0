"""gpufhe_tpu_torch — the PyTorch + CUDA port of gpufhe_tpu (CKKS main path).

The module tree mirrors gpufhe_tpu's, so each module's counterpart has the
same path under the other package:

  params/      CKKSParams, presets, NTT-friendly prime generation
  golden/      host sampling (numpy Generators), encoder, keygen, RNS helpers
  ops/         int64 modular arithmetic, device tables, the negacyclic NTT
               (kernel K1, csrc/ntt.cu) and the RNS base conversion
               (kernel K3, csrc/convert.cu)
  primitives/  ModUp / ModDown / rescale, hybrid key switching
  keys/        Montgomery-form device keys and the key chest
  encoding/    canonical-embedding encode/decode, plaintext upload
  ciphertext/  encrypt / decrypt, tensor, relinearize, rescale, ct_mul_full
  interop      carrying gpufhe_tpu state (numpy arrays) into this package

Residues are int64 tensors holding canonical values in [0, q) for primes
q < 2^30, so every product of two residues fits in 60 bits. Entry points
take an explicit ``device`` (default ``"cuda"``). A CPU tensor runs each
kernel's plain PyTorch version; a CUDA tensor launches the hand-written
kernel. This package imports neither jax nor gpufhe_tpu.
"""

__version__ = "0.1.0"
