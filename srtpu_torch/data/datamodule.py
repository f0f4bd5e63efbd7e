"""The predict half of srtpu's ``SRData`` (srtpu/data/datamodule.py)."""

from __future__ import annotations

from .pipeline import PredictLoader
from .sources import predict_dir


class SRData:
    """Predict datasets under ``datasets_dir``: each a flat image folder,
    or ``<name>/LR/X{scale}`` / ``<name>/LR``. Inputs are edge-padded to
    ``eval_bucket`` multiples, as srtpu's predict loader does."""

    def __init__(self, datasets_dir: str = 'datasets',
                 predict_datasets: list[str] | tuple[str, ...] = (),
                 scale_factor: int = 4, eval_bucket: int = 32):
        self.datasets_dir = datasets_dir
        self.predict_dataset_names = list(predict_datasets)
        self.scale_factor = scale_factor
        self.eval_bucket = eval_bucket
        self._folders = None

    def setup(self, stage: str = 'predict') -> None:
        if stage != 'predict':
            raise NotImplementedError(
                f'srtpu_torch has only the predict stage so far, not '
                f'{stage!r}; see ROADMAP.md')
        self._folders = [predict_dir(self.datasets_dir, n, self.scale_factor)
                         for n in self.predict_dataset_names]

    def predict_loaders(self) -> list[PredictLoader]:
        if self._folders is None:
            raise RuntimeError('call setup("predict") first')
        return [PredictLoader(f, self.scale_factor, self.eval_bucket)
                for f in self._folders]
