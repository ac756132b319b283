from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS, SMOLLM_135M, get_arch
