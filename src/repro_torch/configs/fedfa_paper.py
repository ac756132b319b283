"""The registry's ``FEDFA_PAPER_TRANSFORMER`` as a module of its own
(``CONFIG``)."""
from repro_torch.configs.registry import FEDFA_PAPER_TRANSFORMER as CONFIG

__all__ = ["CONFIG"]
