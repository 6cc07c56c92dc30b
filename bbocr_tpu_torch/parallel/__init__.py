from bbocr_tpu_torch.parallel.mesh import MeshConfig, make_mesh, single_device_mesh
from bbocr_tpu_torch.parallel.sharding import (
    batch_sharding,
    param_shardings,
    replicate_sharding,
)

__all__ = [
    "MeshConfig",
    "make_mesh",
    "batch_sharding",
    "param_shardings",
    "replicate_sharding",
]
