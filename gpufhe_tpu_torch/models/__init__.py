from gpufhe_tpu_torch.models.logreg import EncryptedLogReg, rotations_needed  # noqa: F401
from gpufhe_tpu_torch.models.logreg_train import (  # noqa: F401
    EncryptedLogRegTrainer,
    train_rotations,
)
from gpufhe_tpu_torch.models.mlp import EncryptedMLP, mlp_rotations  # noqa: F401
