from sitewhere_tpu_torch.rest.api import RestServer

__all__ = ["RestServer"]
