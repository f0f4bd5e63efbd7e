from .loop import Trainer, TrainerConfig
from .state import TrainState
from .steps import make_predict_step, make_train_step

__all__ = ['TrainState', 'Trainer', 'TrainerConfig', 'make_predict_step',
           'make_train_step']
