"""The registry's ``SMOLLM_135M`` as a module of its own (``CONFIG``)."""
from repro_torch.configs.registry import SMOLLM_135M as CONFIG

__all__ = ["CONFIG"]
