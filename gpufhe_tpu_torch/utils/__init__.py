from gpufhe_tpu_torch.utils.profiling import Timer, stage, trace  # noqa: F401
from gpufhe_tpu_torch.utils.serialization import (  # noqa: F401
    load_ciphertext,
    load_keychest,
    save_ciphertext,
    save_keychest,
)
