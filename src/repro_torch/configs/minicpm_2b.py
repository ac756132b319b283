"""The registry's ``MINICPM_2B`` as a module of its own (``CONFIG``)."""
from repro_torch.configs.registry import MINICPM_2B as CONFIG

__all__ = ["CONFIG"]
