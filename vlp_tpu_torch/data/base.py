"""The k-fold data module's interface (counterpart of
``vlp_tpu/data/base.py``; reference src/data/KFoldCVDataModule.py:6-43):
``folds()`` yields one ``Fold`` per CV split and ``test_loader(fold)``
gives the frozen test split. The port's ``DownstreamData`` and
``PretrainData`` are registered as its virtual subclasses.
"""
from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Generator

if TYPE_CHECKING:  # pragma: no cover
    from vlp_tpu_torch.data.datamodule import Fold
    from vlp_tpu_torch.data.pipeline import DeviceLoader


class KFoldDataModule(abc.ABC):
    """Per-fold loader construction over a frozen train/test partition."""

    @abc.abstractmethod
    def folds(self) -> "Generator[Fold, None, None]":
        """Yield one Fold (train loader, named val loaders, per-fold statics,
        label weights) per CV split."""

    @abc.abstractmethod
    def test_loader(self, fold: int) -> "DeviceLoader":
        """Frozen test split with fold-matched normalisation; pretrain data
        raises by design (reference PretrainDataModule.py:351-359)."""


def register_virtual_subclasses() -> None:
    from vlp_tpu_torch.data.datamodule import DownstreamData, PretrainData

    KFoldDataModule.register(DownstreamData)
    KFoldDataModule.register(PretrainData)


register_virtual_subclasses()
