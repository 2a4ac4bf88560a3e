"""DataModules: fold-wise loader construction for downstream and pretrain
(counterpart of ``vlp_tpu/data/datamodule.py``).

``DownstreamData`` (INTERNAL + BTXRD, 4-fold CV, per-fold scalar mean/std
and class weights, a frozen test split) and ``PretrainData`` (LERA + MURA,
5-fold CV, joint caption tokenization, ``NoDuplicateCaptionSampler``
batches) yield ``Fold``s of ``DeviceLoader``s over the uint8 image cache,
the same folds, statics and batches as the JAX package's for a config
(``tests/test_torch_port_data.py``, ``tests/test_torch_port_datasets.py``).
``data.name=downstream|pretrain`` read the real datasets (``datasets.py``,
under ``*_DATASET_PATH``) and build their image cache
(``ImageCache.build`` under ``<output_dir>/datacache``, the C++ route);
``synthetic_downstream|synthetic_pretrain`` generate corpora. On a data
mesh (``mesh``) rank 0 reads the datasets first, so that it alone writes
their files (MURA's test-set hash, LERA's index) and the image cache; the
other ranks read them after a barrier. Every loader, the evaluation and
test loaders too, gives this rank's rows of each global batch, so
``data.batch_size`` and ``data.eval_batch_size`` must divide by the world
(``pipeline.DeviceLoader``).
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np
import torch

from vlp_tpu_torch.config import Config
from vlp_tpu_torch.data import synthetic
from vlp_tpu_torch.data.captions import DEFAULT_CAPTIONS_CSV, CaptionPool
from vlp_tpu_torch.data.datasets import (BTXRDDataset, InternalDataset,
                                         LERADataset, MURADataset)
from vlp_tpu_torch.data.pipeline import ArrayBundle, DeviceLoader
from vlp_tpu_torch.data.preprocess_host import ImageCache, fold_mean_std
from vlp_tpu_torch.data.sampler import (NoDuplicateCaptionSampler,
                                        ShuffleBatchSampler)
from vlp_tpu_torch.data.splits import (DOWNSTREAM_STRATIFY, PRETRAIN_STRATIFY,
                                       btxrd_stratify_label, class_weights,
                                       cv_splits)
from vlp_tpu_torch.data.tokenize import tokenize_all_captions
from vlp_tpu_torch.models.tasks import TaskStatics
from vlp_tpu_torch.ops.augment import AugmentConfig


@dataclasses.dataclass
class Fold:
    index: int
    train_loader: DeviceLoader
    val_loaders: Dict[str, DeviceLoader]
    statics: TaskStatics
    label_weights: Tuple[float, float]


def _augment_config(cfg: Config) -> AugmentConfig:
    return AugmentConfig(
        enabled=not cfg.data.disable_augmentations,
        noise_prob=0.5 if cfg.data.gaussian_noise_augmentation else 0.0,
        shear_deg=5.0 if cfg.data.shear_augmentation else 0.0)


def _subsample(samples: List[dict], n: Optional[int], seed: int) -> List[dict]:
    """try_with_only_n_samples (reference DownstreamDataModule.py:284-300)."""
    if n is None or n >= len(samples):
        return samples
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(samples), size=n, replace=False)
    return [samples[i] for i in idx]


def _rank0_first(mesh, read):
    """``read()`` on rank 0, then on the other ranks after a barrier: the
    files it writes (hashes, indexes, the image cache) are written once."""
    if mesh is None:
        return read()
    out = read() if mesh.is_main else None
    mesh.barrier()
    return out if mesh.is_main else read()


class DownstreamData:
    """INTERNAL+BTXRD; folds combine each dataset's own CV splits
    (INTERNAL grouped by patient, BTXRD ungrouped, reference
    DownstreamDataModule.py:255-337)."""

    def __init__(self, cfg: Config, device, cache_dir: Optional[str] = None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device)
        self.cache_dir = cache_dir or os.path.join(cfg.output_dir, "datacache")
        d = cfg.data
        if d.name == "synthetic_downstream":
            samples, self.cache = synthetic.make_synthetic_downstream(
                d.synthetic_num_samples, d.image_size, seed=d.seed,
                crop=d.crop_larger_dimension)
            # frozen "test" split for synthetic: last 25%
            n_test = max(1, len(samples) // 4)
            self.test = samples[-n_test:]
            train_val = samples[:-n_test]
        else:
            train_val, self.test, self.cache = _rank0_first(
                mesh, self._read_real)
            samples = train_val + self.test
        self.train_val = _subsample(train_val, d.try_with_only_n_samples,
                                    d.seed)
        self._cache_index = {s["image_path"]: i
                             for i, s in enumerate(samples)}
        self._statics_cache: Dict[int, TaskStatics] = {}

    def _read_real(self):
        """INTERNAL + BTXRD: their frozen splits and the cache of every
        image, train/val then test (reference
        DownstreamDataModule.py:203-253)."""
        d = self.cfg.data
        internal = InternalDataset(cache_dir=self.cache_dir)
        btxrd = BTXRDDataset(cache_dir=self.cache_dir)
        train_val = list(internal.train_val) + list(btxrd.train_val)
        test = list(internal.test) + list(btxrd.test)
        cache = ImageCache.build(
            [s["image_path"] for s in train_val + test], self.cache_dir,
            image_size=d.image_size, crop=d.crop_larger_dimension,
            maximum_crop_ratio=d.maximum_crop_ratio)
        return train_val, test, cache

    def _indices(self, samples: List[dict]) -> List[int]:
        return [self._cache_index[s["image_path"]] for s in samples]

    def _loader(self, samples: List[dict], sampler, batch_size: int
                ) -> DeviceLoader:
        return DeviceLoader(
            ArrayBundle(samples, self.cache, self._indices(samples)),
            sampler, batch_size, self.device, self.cfg.data.prefetch_depth,
            self.mesh)

    def _fold_splits(self):
        d = self.cfg.data
        internal = [s for s in self.train_val if s["dataset"] == "INTERNAL"]
        btxrd = [s for s in self.train_val if s["dataset"] == "BTXRD"]
        empty = [([], [])] * d.n_folds_downstream
        folds_i = cv_splits(internal, n_splits=d.n_folds_downstream,
                            stratify_keys=DOWNSTREAM_STRATIFY,
                            group_key="patient_number", seed=d.seed) \
            if internal else empty
        folds_b = cv_splits(btxrd, n_splits=d.n_folds_downstream,
                            stratify_fn=btxrd_stratify_label, group_key=None,
                            seed=d.seed) if btxrd else empty
        out = []
        for k in range(d.n_folds_downstream):
            tr = [internal[i] for i in folds_i[k][0]] + \
                 [btxrd[i] for i in folds_b[k][0]]
            out.append((tr, {"internal": [internal[i] for i in folds_i[k][1]],
                             "btxrd": [btxrd[i] for i in folds_b[k][1]]}))
        return out

    def folds(self) -> Generator[Fold, None, None]:
        cfg, d = self.cfg, self.cfg.data
        for k, (train, vals) in enumerate(self._fold_splits()):
            mean, std = fold_mean_std(self.cache, self._indices(train),
                                      self.cache_dir)
            weights = class_weights([s["tumor"] for s in train])
            statics = TaskStatics(
                mean=mean, std=std, class_weights=weights,
                out_channels=d.in_channels,
                scale_intensity=d.scale_intensity_normalization,
                augment=_augment_config(cfg))
            self._statics_cache[k] = statics
            train_loader = self._loader(
                train, ShuffleBatchSampler(len(train), d.batch_size,
                                           seed=d.seed + k), d.batch_size)
            val_loaders = {
                name: self._loader(v, ShuffleBatchSampler(
                    len(v), d.eval_batch_size, shuffle=False),
                    d.eval_batch_size)
                for name, v in vals.items() if len(v) > 0}
            yield Fold(k, train_loader, val_loaders, statics, weights)

    def fold_statics(self, fold: int) -> TaskStatics:
        if fold not in self._statics_cache:
            for _ in self.folds():
                pass
        return self._statics_cache[fold]

    def test_loader(self, fold: int) -> DeviceLoader:
        """Frozen combined test split (reference
        DownstreamDataModule.py:340-383); ``fold_statics(fold)`` gives its
        normalisation."""
        self.fold_statics(fold)
        d = self.cfg.data
        return self._loader(self.test, ShuffleBatchSampler(
            len(self.test), d.eval_batch_size, shuffle=False),
            d.eval_batch_size)


class PretrainData:
    """LERA+MURA with caption-unique batching and joint tokenization
    (reference PretrainDataModule.py)."""

    def __init__(self, cfg: Config, device, cache_dir: Optional[str] = None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device)
        self.cache_dir = cache_dir or os.path.join(cfg.output_dir, "datacache")
        d = cfg.data
        if d.name == "synthetic_pretrain":
            samples, self.cache = synthetic.make_synthetic_pretrain(
                d.synthetic_num_samples, d.image_size, seed=d.seed,
                captions_csv=d.captions_csv)
        else:
            samples, self.cache = _rank0_first(mesh, self._read_real)
        self._cache_index = {s["image_path"]: i
                             for i, s in enumerate(samples)}
        self.train_val = _subsample(samples, d.try_with_only_n_samples,
                                    d.seed)

    def _read_real(self):
        """LERA + MURA train/val (captions cycled from one pool, LERA
        first) and their image cache; MURA's valid split, the test set,
        only checked against its hash."""
        d = self.cfg.data
        pool = CaptionPool(d.captions_csv or DEFAULT_CAPTIONS_CSV)
        lera = LERADataset(pool, cache_dir=self.cache_dir)
        mura = MURADataset(pool, cache_dir=self.cache_dir)
        samples = list(lera.train_val) + list(mura.train_val)
        cache = ImageCache.build([s["image_path"] for s in samples],
                                 self.cache_dir, image_size=d.image_size)
        return samples, cache

    def _loader(self, samples: List[dict], tokens, sampler,
                batch_size: int) -> DeviceLoader:
        ids, mask = tokens
        bundle = ArrayBundle(
            samples, self.cache,
            [self._cache_index[s["image_path"]] for s in samples],
            token_ids=ids, token_mask=mask)
        return DeviceLoader(bundle, sampler, batch_size, self.device,
                            self.cfg.data.prefetch_depth, self.mesh)

    def folds(self) -> Generator[Fold, None, None]:
        cfg, d = self.cfg, self.cfg.data
        lera = [s for s in self.train_val if s["dataset"] == "LERA"]
        mura = [s for s in self.train_val if s["dataset"] == "MURA"]
        empty = [([], [])] * d.n_folds_pretrain
        folds_l = cv_splits(lera, n_splits=d.n_folds_pretrain,
                            stratify_keys=PRETRAIN_STRATIFY,
                            group_key="case_number", seed=d.seed) \
            if lera else empty
        folds_m = cv_splits(mura, n_splits=d.n_folds_pretrain,
                            stratify_keys=PRETRAIN_STRATIFY,
                            group_key="patient_id", seed=d.seed) \
            if mura else empty
        for k in range(d.n_folds_pretrain):
            train = [lera[i] for i in folds_l[k][0]] + \
                    [mura[i] for i in folds_m[k][0]]
            val_l = [lera[i] for i in folds_l[k][1]]
            val_m = [mura[i] for i in folds_m[k][1]]
            tokens = tokenize_all_captions(
                {"train": train, "lera": val_l, "mura": val_m},
                d.tokenizer, d.max_token_length)
            mean, std = fold_mean_std(
                self.cache, [self._cache_index[s["image_path"]]
                             for s in train], self.cache_dir)
            statics = TaskStatics(
                mean=mean, std=std, out_channels=d.in_channels,
                scale_intensity=d.scale_intensity_normalization,
                augment=_augment_config(cfg))
            train_loader = self._loader(
                train, tokens["train"], NoDuplicateCaptionSampler(
                    len(train), [s["caption_id"] for s in train],
                    d.batch_size, probabilistic_mode=d.sampler_mode_train,
                    seed=d.seed + k), d.batch_size)
            val_loaders = {}
            for name, vs in (("lera", val_l), ("mura", val_m)):
                if vs:
                    val_loaders[name] = self._loader(
                        vs, tokens[name], NoDuplicateCaptionSampler(
                            len(vs), [s["caption_id"] for s in vs],
                            d.eval_batch_size,
                            probabilistic_mode=d.sampler_mode_val,
                            deterministic=True, seed=d.seed),
                        d.eval_batch_size)
            yield Fold(k, train_loader, val_loaders, statics, (1.0, 1.0))

    def test_loader(self, fold: int):
        raise RuntimeError(
            "PretrainData deliberately exposes no test loader: the MURA "
            "test split must not be consumed during pretraining "
            "(reference PretrainDataModule.py:351-359).")


def downstream_config(cfg: Config) -> Config:
    """The downstream data of a run, as a config of its own (a deep copy:
    the caller's cfg is not changed): a VLP config's ``downstream_data``
    (its ``data`` is the caption corpus; ``synthetic_downstream`` where it
    pretrains on a synthetic corpus), a classifier config's ``data``; the
    run's mesh and output directory."""
    ds_cfg = Config()
    if cfg.model.task == "vision_language":
        ds_cfg.data = copy.deepcopy(cfg.downstream_data)
        if cfg.data.name.startswith("synthetic"):
            ds_cfg.data.name = "synthetic_downstream"
    else:
        ds_cfg.data = copy.deepcopy(cfg.data)
    ds_cfg.mesh = cfg.mesh
    ds_cfg.output_dir = cfg.output_dir
    return ds_cfg


def build_datamodule(cfg: Config, device, cache_dir: Optional[str] = None,
                     mesh=None):
    name = cfg.data.name
    if name in ("downstream", "synthetic_downstream"):
        return DownstreamData(cfg, device, cache_dir, mesh)
    if name in ("pretrain", "synthetic_pretrain"):
        return PretrainData(cfg, device, cache_dir, mesh)
    raise ValueError(f"unknown data module {name!r}")
