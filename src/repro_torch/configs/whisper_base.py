"""The registry's ``WHISPER_BASE`` as a module of its own (``CONFIG``)."""
from repro_torch.configs.registry import WHISPER_BASE as CONFIG

__all__ = ["CONFIG"]
