from sitewhere_tpu_torch.utils.capacity import grow_pow2
from sitewhere_tpu_torch.utils.device import resolve_device

__all__ = ["grow_pow2", "resolve_device"]
