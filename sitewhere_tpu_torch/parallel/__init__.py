"""Per-tenant model stacking (`tenant_stack.py`) and single-device
attention (`ring.py`). Mesh sharding of the stack, the stacked rings and
ring attention over several cards is not ported yet (ROADMAP A.2)."""

from sitewhere_tpu_torch.parallel.ring import dense_attention
from sitewhere_tpu_torch.parallel.tenant_stack import TenantStack

__all__ = ["TenantStack", "dense_attention"]
