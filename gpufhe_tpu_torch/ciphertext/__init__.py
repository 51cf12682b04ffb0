"""ciphertext layer of gpufhe_tpu_torch (see the package docstring).

Re-exports the reference's names (gpufhe_tpu/ciphertext/__init__.py)."""

from gpufhe_tpu_torch.ciphertext.ct import (  # noqa: F401
    Ciphertext,
    ct_add,
    ct_conjugate,
    ct_mul,
    ct_mul_plain,
    ct_relinearize,
    ct_rescale,
    ct_rotate,
    ct_sub,
    ct_tensor,
    decrypt_decode,
    decrypt_to_coeff,
    encrypt,
)
