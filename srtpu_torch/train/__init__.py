from .gan import (GANTrainState, create_gan_state, make_gan_train_step,
                  steplr_adam)
from .loop import Trainer, TrainerConfig
from .state import TrainState
from .steps import make_predict_step, make_train_step

__all__ = ['GANTrainState', 'TrainState', 'Trainer', 'TrainerConfig',
           'create_gan_state', 'make_gan_train_step', 'make_predict_step',
           'make_train_step', 'steplr_adam']
