"""ops layer of gpufhe_tpu_torch (see the package docstring).

Re-exports the reference's names (gpufhe_tpu/ops/__init__.py)."""

from gpufhe_tpu_torch.ops.context import (  # noqa: F401
    Context,
    NTTTables,
    fourstep_split,
    make_context,
)
from gpufhe_tpu_torch.ops.modops import (  # noqa: F401
    add_mod,
    barrett_reduce_u32,
    from_mont,
    mont_mul,
    mul_mod,
    mulhi32,
    neg_mod,
    sub_mod,
    to_mont,
)
from gpufhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv  # noqa: F401
