"""keys layer of gpufhe_tpu_torch (see the package docstring).

Re-exports the reference's names (gpufhe_tpu/keys/__init__.py)."""

from gpufhe_tpu_torch.keys.keys import (  # noqa: F401
    DeviceKSKey,
    DevicePublicKey,
    DeviceSecretKey,
    KeyChest,
    keygen,
    upload_ks_key,
    upload_public_key,
    upload_secret_key,
)
