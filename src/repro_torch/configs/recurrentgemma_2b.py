"""The registry's ``RECURRENTGEMMA_2B`` as a module of its own (``CONFIG``)."""
from repro_torch.configs.registry import RECURRENTGEMMA_2B as CONFIG

__all__ = ["CONFIG"]
