"""The multi-device layer: a ('limb', 'coeff') mesh of shards (mesh.py), the
sharded programs (sharded.py, bfv_sharded.py), the sharded backend
(backend.py), the bootstrap's program planner (planner.py) and meshes
across processes (multihost.py). Counterpart of gpufhe_tpu/parallel/."""

from gpufhe_tpu_torch.parallel.multihost import (  # noqa: F401
    global_fhe_mesh,
    initialize_multihost,
    scaling_report,
    weak_scaling_report,
)
from gpufhe_tpu_torch.parallel.sharded import (  # noqa: F401
    make_fhe_mesh,
    make_sharded_mult,
    shard_ct_component,
    unshard_ct_component,
)
