"""The registry's ``TINYLLAMA_1B`` as a module of its own (``CONFIG``)."""
from repro_torch.configs.registry import TINYLLAMA_1B as CONFIG

__all__ = ["CONFIG"]
