from repro_torch.configs.base import (ArchConfig, EncoderConfig, MoEConfig,
                                     RGLRUConfig, SSMConfig, VisionConfig)
from repro_torch.configs.registry import (ARCHS, ARCTIC_480B, CODEQWEN_7B,
                                          FEDFA_PAPER_TRANSFORMER,
                                          INTERNVL2_76B, MAMBA2_130M,
                                          MINICPM_2B, PHI35_MOE,
                                          RECURRENTGEMMA_2B, SMOLLM_135M,
                                          TINYLLAMA_1B, WHISPER_BASE, get_arch)
