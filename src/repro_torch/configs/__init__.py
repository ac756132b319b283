from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.configs.registry import (ARCHS, CODEQWEN_7B,
                                          FEDFA_PAPER_TRANSFORMER, MAMBA2_130M,
                                          MINICPM_2B, SMOLLM_135M,
                                          TINYLLAMA_1B, get_arch)
