from repro_torch.optim.optimizers import (OptState, adamw, init_opt,
                                          opt_update, sgd_momentum)
from repro_torch.optim.schedules import make_schedule
