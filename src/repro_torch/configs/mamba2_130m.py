"""The registry's ``MAMBA2_130M`` as a module of its own (``CONFIG``)."""
from repro_torch.configs.registry import MAMBA2_130M as CONFIG

__all__ = ["CONFIG"]
