"""The registry's ``INTERNVL2_76B`` as a module of its own (``CONFIG``)."""
from repro_torch.configs.registry import INTERNVL2_76B as CONFIG

__all__ = ["CONFIG"]
