from .loop import Trainer, TrainerConfig
from .steps import make_predict_step

__all__ = ['Trainer', 'TrainerConfig', 'make_predict_step']
