from repro_torch.configs.base import (ArchConfig, DECODE_32K, EncoderConfig,
                                     INPUT_SHAPES, InputShape, LONG_500K,
                                     MoEConfig, PREFILL_32K, RGLRUConfig,
                                     SSMConfig, TRAIN_4K, VisionConfig)
from repro_torch.configs.registry import (ARCHS, ARCTIC_480B, ASSIGNED,
                                          CODEQWEN_7B,
                                          FEDFA_PAPER_TRANSFORMER,
                                          INTERNVL2_76B, MAMBA2_130M,
                                          MINICPM_2B, PHI35_MOE,
                                          RECURRENTGEMMA_2B, SMOLLM_135M,
                                          TINYLLAMA_1B, WHISPER_BASE, get_arch)
