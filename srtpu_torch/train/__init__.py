from .gan import (GANTrainState, create_gan_state, make_gan_train_step,
                  steplr_adam)
from .graph import StepGraph
from .loop import Trainer, TrainerConfig
from .state import TrainState, Updater, loss_parameters
from .steps import (make_eval_step, make_multi_train_step,
                    make_predict_step, make_tiled_eval_step,
                    make_tiled_predict_step, make_train_step)
from .tiled import make_tiled_apply, receptive_field_radius, tiled_predict

__all__ = ['GANTrainState', 'StepGraph', 'TrainState', 'Trainer',
           'TrainerConfig', 'create_gan_state', 'loss_parameters',
           'make_eval_step', 'make_gan_train_step', 'make_multi_train_step',
           'make_predict_step', 'make_tiled_apply',
           'make_tiled_eval_step', 'make_tiled_predict_step',
           'make_train_step',
           'receptive_field_radius', 'steplr_adam', 'tiled_predict',
           'Updater']
