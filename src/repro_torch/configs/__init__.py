from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.configs.registry import (ARCHS, MAMBA2_130M, SMOLLM_135M,
                                          get_arch)
