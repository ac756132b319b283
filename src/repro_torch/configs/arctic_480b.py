"""The registry's ``ARCTIC_480B`` as a module of its own (``CONFIG``)."""
from repro_torch.configs.registry import ARCTIC_480B as CONFIG

__all__ = ["CONFIG"]
