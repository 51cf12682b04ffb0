"""primitives layer of gpufhe_tpu_torch (see the package docstring).

Re-exports the reference's names (gpufhe_tpu/primitives/__init__.py)."""

from gpufhe_tpu_torch.primitives.keyswitch import key_switch_core, qp_indices  # noqa: F401
from gpufhe_tpu_torch.primitives.rns import (  # noqa: F401
    KSContext,
    base_convert,
    make_ks_context,
    mod_down,
    mod_up,
    rescale,
)
