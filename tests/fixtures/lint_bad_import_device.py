"""Planted fixture for ``repro_torch.analysis.lint``: device work at module
import time, and a bare assert.  Never imported."""
import torch

SCALE = 0.5
HOST = torch.zeros(4)                               # fine: on the CPU


torch.cuda.synchronize()                            # import-time-device
ONES = torch.ones(4, device="cuda")                 # import-time-device
MOVED = HOST.cuda()                                 # import-time-device
MOVED2 = HOST.to("cuda:0")                          # import-time-device


def later():
    return torch.zeros(4, device="cuda")            # fine: deferred


assert SCALE > 0                                    # bare-assert
