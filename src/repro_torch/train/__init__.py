from repro_torch.train.steps import (make_eval_step, make_train_state,
                                     make_train_step, train_state_from_params)
from repro_torch.train.loop import train_loop
