"""encoding layer of gpufhe_tpu_torch (see the package docstring).

Re-exports the reference's names (gpufhe_tpu/encoding/__init__.py)."""

from gpufhe_tpu_torch.encoding.encoder import (  # noqa: F401
    decode,
    encode,
    encode_to_device,
    plaintext_to_device,
)
