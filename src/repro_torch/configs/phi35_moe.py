"""The registry's ``PHI35_MOE`` as a module of its own (``CONFIG``)."""
from repro_torch.configs.registry import PHI35_MOE as CONFIG

__all__ = ["CONFIG"]
