"""The registry's ``CODEQWEN_7B`` as a module of its own (``CONFIG``)."""
from repro_torch.configs.registry import CODEQWEN_7B as CONFIG

__all__ = ["CONFIG"]
