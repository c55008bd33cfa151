"""Device meshes and sharding (`mesh.py`), the multi-process entry
(`distributed.py`), per-tenant model stacking (`tenant_stack.py`),
dense and ring attention (`ring.py`) and the fleet's tenant placement
(`placement.py`)."""

from sitewhere_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    mesh_from_spec,
    replicated,
    shard_batch,
)
from sitewhere_tpu_torch.parallel.ring import (
    dense_attention,
    ring_attention,
    ring_attention_sharded,
)
from sitewhere_tpu_torch.parallel.tenant_stack import TenantStack

__all__ = ["Mesh", "make_mesh", "mesh_from_spec", "batch_sharding",
           "replicated", "shard_batch", "TenantStack", "dense_attention",
           "ring_attention", "ring_attention_sharded"]
