"""Per-tenant model stacking (`tenant_stack.py`). Mesh sharding of the
stack and the stacked rings over several cards is not ported yet."""

from sitewhere_tpu_torch.parallel.tenant_stack import TenantStack

__all__ = ["TenantStack"]
