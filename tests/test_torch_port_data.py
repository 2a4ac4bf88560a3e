"""The port's data path (``vlp_tpu_torch/data``) against the JAX package's,
on the CPU: the caption pool against pandas row by row; ``cv_splits``
(scikit-learn's two splitters written in numpy) on many seeds and sizes,
grouped and ungrouped, with the BTXRD label rule, the thin-class fallback
and its warnings, and the raising case; ``class_weights``,
``hash_list_of_strings``, ``fold_mean_std`` and its cache file;
``ImageCache.open`` on a cache that the JAX ``ImageCache.build`` wrote;
the numpy ``INTER_AREA`` against cv2; the synthetic corpora; the samplers' index sequences with
their RNG state round trips; and each fold's statics and first-epoch
batches against the JAX data modules' loaders, resident and host-assembled,
on the synthetic corpora and on the real datasets' readers over a fixture
corpus in their layouts (the port decoding with its PNG reader, the image
caches' files byte-equal).

Every comparison is exact: the same draws from the same seeded generators,
the same float32 operations in the same order.
"""
import os
import warnings

import cv2
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from vlp_tpu.config import apply_overrides as japply
from vlp_tpu.config import get_experiment as jget
from vlp_tpu.data import preprocess_host as jph
from vlp_tpu.data import sampler as jsampler
from vlp_tpu.data import splits as jsplits
from vlp_tpu.data import synthetic as jsynthetic
from vlp_tpu.data.captions import CaptionPool as JPool
from vlp_tpu.data.datamodule import build_datamodule as jbuild_dm
from vlp_tpu_torch.config import apply_overrides, get_experiment
from vlp_tpu_torch.data import pipeline, preprocess_host, sampler, splits
from vlp_tpu_torch.data import synthetic
from vlp_tpu_torch.data.captions import DEFAULT_CAPTIONS_CSV, CaptionPool
from vlp_tpu_torch.data.datamodule import build_datamodule

import chip_smoke_data

CPU = torch.device("cpu")


# --------------------------------------------------------------------------
# captions
# --------------------------------------------------------------------------

def test_caption_pool_reads_the_csv_as_pandas_does(tmp_path):
    df = pd.read_csv(DEFAULT_CAPTIONS_CSV)
    pool = CaptionPool()
    assert pool.num_captions == len(df) == 880
    for idx, row in df.iterrows():
        assert pool.rows[idx] == {
            "anatomy_site": str(row["anatomy_site"]),
            "abnormality_label": str(int(row["abnormality_label"])),
            "caption": str(row["caption"])}
    assert pool.all_captions() == JPool().all_captions()
    assert any("," in c for c in pool.all_captions())
    # commas, doubled quotes and a blank line, as pandas reads them
    odd = tmp_path / "odd.csv"
    odd.write_text('anatomy_site,abnormality_label,caption\n'
                   'KNEE,1,"a lesion, with ""quotes"", here"\n\n'
                   'KNEE,1,plain\nHIP,0,"multi\nline"\n')
    assert CaptionPool(str(odd)).all_captions() == \
        JPool(str(odd)).all_captions()
    with pytest.raises(ValueError, match="must have columns"):
        bad = tmp_path / "bad.csv"
        bad.write_text("site,label\nKNEE,1\n")
        CaptionPool(str(bad))


def test_caption_assignment_cycles_as_the_jax_pool():
    ours, theirs = CaptionPool(), JPool()
    assert ours.sites() == theirs.sites()
    rng = np.random.default_rng(0)
    keys = [(str(rng.choice(ours.sites())), int(rng.integers(2)))
            for _ in range(300)]
    assert ours.assign_all(keys) == theirs.assign_all(keys)
    with pytest.raises(KeyError):
        ours.assign("NOSE", 1)


# --------------------------------------------------------------------------
# splits
# --------------------------------------------------------------------------

def _samples(rng, n, sites, n_patients):
    return [{"tumor": int(rng.integers(2)),
             "label": int(rng.integers(2)),
             "anatomy_site": str(rng.choice(sites)),
             "patient_number": f"P{int(rng.integers(n_patients))}"}
            for _ in range(n)]


def _run(module, samples, **kw):
    """(folds or the error's text, warnings' texts)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = module.cv_splits(samples, **kw)
        except ValueError as e:
            out = ("ValueError", str(e))
    return out, [str(w.message) for w in caught]


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("rule", ["keys", "btxrd"])
@pytest.mark.parametrize("n_splits", [4, 5])
def test_cv_splits_match_sklearn_on_many_seeds_and_sizes(grouped, rule,
                                                         n_splits):
    seen = set()
    for seed in range(12):
        rng = np.random.default_rng(seed)
        for n in (3, 7, 12, 30, 61, 150):
            sites = ["knee", "hip", "arm", "foot"][:1 + seed % 4]
            samples = _samples(rng, n, sites, max(2, n // (1 + seed % 3)))
            kw = dict(n_splits=n_splits, seed=seed,
                      group_key="patient_number" if grouped else None)
            got = _run(splits, samples, **kw, **(
                {"stratify_fn": splits.btxrd_stratify_label}
                if rule == "btxrd" else
                {"stratify_keys": splits.DOWNSTREAM_STRATIFY}))
            want = _run(jsplits, samples, **kw, **(
                {"stratify_fn": jsplits.btxrd_stratify_label}
                if rule == "btxrd" else
                {"stratify_keys": jsplits.DOWNSTREAM_STRATIFY}))
            assert got == want, (seed, n)
            seen.add("raises" if got[0][0] == "ValueError" else
                     "falls back" if any("primary" in w for w in got[1])
                     else "warns" if got[1] else "clean")
    # the fallback, its warning, the raising case and clean runs all ran
    assert {"raises", "falls back", "clean"} <= seen


def test_small_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    for _ in range(5):
        labels = rng.integers(0, 2, int(rng.integers(1, 40)))
        assert splits.class_weights(labels) == jsplits.class_weights(labels)
    assert splits.class_weights([1, 1]) == jsplits.class_weights([1, 1])
    words = [str(w) for w in rng.integers(0, 10 ** 6, 20)]
    assert splits.hash_list_of_strings(words) == \
        jsplits.hash_list_of_strings(words)
    a = [{"patient_number": "P1"}, {"patient_number": "P2"}]
    splits.assert_no_group_leakage(a[:1], a[1:], "patient_number")
    with pytest.raises(AssertionError):
        splits.assert_no_group_leakage(a, a[1:], "patient_number")
    images = rng.integers(0, 256, (9, 16, 16), dtype=np.uint8)
    ours = preprocess_host.ImageCache.from_arrays(images)
    theirs = jph.ImageCache.from_arrays(images)
    idx = [0, 3, 4, 8]
    got = preprocess_host.fold_mean_std(ours, idx, str(tmp_path / "p"))
    want = jph.fold_mean_std(theirs, idx, str(tmp_path / "j"))
    assert got == want
    assert os.listdir(tmp_path / "p") == os.listdir(tmp_path / "j")
    # the cached value is read back
    assert preprocess_host.fold_mean_std(ours, idx, str(tmp_path / "p")) \
        == got
    assert preprocess_host.fold_mean_std(ours, idx) == got


def test_image_cache_opens_what_jax_image_cache_build_wrote(tmp_path):
    rng = np.random.default_rng(2)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"{i}.png"))
        cv2.imwrite(paths[-1], rng.integers(0, 256, (30 + 5 * i, 24),
                                            np.uint8))
    built = jph.ImageCache.build(paths, str(tmp_path / "cache"),
                                 image_size=32, crop=True, use_native=False)
    opened = preprocess_host.ImageCache.open(
        paths, str(tmp_path / "cache"), image_size=32, crop=True,
        native=False)
    assert np.array_equal(np.asarray(opened.data), np.asarray(built.data))
    assert opened.options_key == built.options_key
    assert np.array_equal(opened.gather([3, 1]), built.gather([3, 1]))
    with pytest.raises(FileNotFoundError):
        preprocess_host.ImageCache.open(paths, str(tmp_path / "cache"),
                                        image_size=64, native=False)


@pytest.mark.parametrize("side,size", [(97, 224), (116, 224), (80, 32),
                                       (96, 32), (128, 64), (140, 70),
                                       (66, 33), (300, 64), (45, 45 * 2)])
def test_numpy_area_resize_is_cv2s(side, size):
    img = (np.random.default_rng(side).random((side, side)) * 255).astype(
        np.float32)
    want = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
    assert np.array_equal(preprocess_host.resize_area(img, size), want)


@pytest.mark.parametrize("kind", ["downstream", "pretrain"])
def test_synthetic_corpora_are_the_jax_packages(kind):
    fn = f"make_synthetic_{kind}"
    for seed, n, size, kw in ((0, 24, 64, {}), (5, 13, 32, {}),
                              (2, 9, 224, {"crop": True}
                               if kind == "downstream" else {})):
        ours, ocache = getattr(synthetic, fn)(n, size, seed=seed, **kw)
        theirs, tcache = getattr(jsynthetic, fn)(n, size, seed=seed, **kw)
        assert np.array_equal(ocache.data, tcache.data)
        assert ocache.paths == tcache.paths
        for a, b in zip(ours, theirs):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]) if isinstance(
                    a[k], np.ndarray) else a[k] == b[k], k


# --------------------------------------------------------------------------
# samplers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "semi"])
def test_no_duplicate_caption_sampler_matches_jax(mode):
    rng = np.random.default_rng(3)
    caption_ids = rng.integers(0, 25, 70).tolist()
    make = lambda m, det=False: m.NoDuplicateCaptionSampler(
        70, caption_ids, 16, probabilistic_mode=mode, deterministic=det,
        seed=9)
    ours, theirs = make(sampler), make(jsampler)
    for _ in range(3):
        assert list(ours) == list(theirs)
    state = ours.rng_state()
    first = list(ours)
    ours.set_rng_state(state)
    assert list(ours) == first
    det, jdet = make(sampler, True), make(jsampler, True)
    epochs = [list(det) for _ in range(2)]
    assert epochs[0] == epochs[1] == list(jdet)
    assert len(det) == len(jdet)


@pytest.mark.parametrize("shuffle,drop", [(True, False), (False, False),
                                          (True, True)])
def test_shuffle_sampler_and_padding_match_jax(shuffle, drop):
    make = lambda m: m.ShuffleBatchSampler(37, 8, shuffle=shuffle, seed=4,
                                           drop_remainder=drop)
    ours, theirs = make(sampler), make(jsampler)
    assert len(ours) == len(theirs)
    for _ in range(3):
        assert list(ours) == list(theirs)
    state = ours.rng_state()
    first = list(ours)
    ours.set_rng_state(state)
    assert list(ours) == first
    for idx in ([1, 2, 3], [5], list(range(8))):
        a, b = sampler.pad_batch_indices(idx, 8), \
            jsampler.pad_batch_indices(idx, 8)
        assert a[0] == b[0] and np.array_equal(a[1], b[1])


# --------------------------------------------------------------------------
# data modules and loaders
# --------------------------------------------------------------------------

DOWNSTREAM = ["data.name=synthetic_downstream", "data.image_size=32",
              "data.batch_size=8", "data.eval_batch_size=8",
              "data.synthetic_num_samples=52"]
PRETRAIN = ["data.image_size=32", "data.batch_size=8",
            "data.eval_batch_size=4", "data.synthetic_num_samples=60",
            "data.max_token_length=12"]


def _batches(loader):
    return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def _same(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


REAL = ["data.image_size=32", "data.batch_size=16",
        "data.eval_batch_size=16", "data.max_token_length=12"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The four real datasets' layouts (``chip_smoke_data.write_corpus``)
    at small sizes: 40 downstream and 60 pretrain PNGs of 20-48 pixels."""
    root = tmp_path_factory.mktemp("corpus")
    env = chip_smoke_data.write_corpus(root, downstream=40, pretrain=60,
                                       sides=(20, 48))
    return root, {k: v for k, v in env.items() if k.endswith("_PATH")}


@pytest.mark.parametrize("name,overrides,real", [
    ("baseline_only_imaging_resnet34", DOWNSTREAM, False),
    ("smoke_synthetic_pretrain", PRETRAIN, False),
    ("baseline_only_imaging_resnet34", REAL, True),
    ("pretrain_resnet34_tinybert", REAL, True)],
    ids=["downstream", "pretrain", "downstream_real", "pretrain_real"])
def test_folds_match_the_jax_data_module(name, overrides, real, tmp_path,
                                         corpus, monkeypatch):
    """The real cases read the fixture corpus through ``*_DATASET_PATH``;
    the port decodes its PNGs with its numpy reader, the JAX package with
    cv2, and both build their caches on the C++ route: the same cache files
    and the same folds, statics and batches."""
    jcfg = japply(jget(name), overrides)
    cfg = apply_overrides(get_experiment(name), overrides)
    jcfg.output_dir, cfg.output_dir = str(tmp_path / "j"), str(tmp_path / "p")
    if real:
        root, env = corpus
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for out in ("j", "p"):
            chip_smoke_data.seed_cache(root, tmp_path / out / "datacache")
        monkeypatch.setattr(preprocess_host, "_cv2", lambda: None)
        monkeypatch.setattr(preprocess_host, "_pil_image", lambda: None)
    jdm, dm = jbuild_dm(jcfg), build_datamodule(cfg, CPU)
    if real:
        names = sorted(os.listdir(tmp_path / "j" / "datacache"))
        assert names == sorted(os.listdir(tmp_path / "p" / "datacache"))
        assert any(n.startswith("imgcache_") for n in names)
        for n in names:
            assert (tmp_path / "j" / "datacache" / n).read_bytes() == \
                (tmp_path / "p" / "datacache" / n).read_bytes(), n
        assert [s["image_path"] for s in dm.train_val] == \
            [s["image_path"] for s in jdm.train_val]
    jfolds, folds = list(jdm.folds()), list(dm.folds())
    assert len(folds) == len(jfolds) > 1
    for fold, jfold in zip(folds, jfolds):
        assert fold.index == jfold.index
        assert fold.label_weights == jfold.label_weights
        for attr in ("mean", "std", "class_weights", "out_channels",
                     "scale_intensity"):
            assert getattr(fold.statics, attr) == \
                getattr(jfold.statics, attr), attr
        # the JAX config also names its warp method, the port's only one
        jaug = jfold.statics.augment._asdict()
        assert jaug.pop("method") == "shear"
        assert fold.statics.augment._asdict() == jaug
        assert fold.train_loader.resident
        _same(_batches(fold.train_loader),
              [jax.device_get(b) for b in jfold.train_loader])
        assert fold.val_loaders.keys() == jfold.val_loaders.keys()
        for key in fold.val_loaders:
            _same(_batches(fold.val_loaders[key]),
                  [jax.device_get(b) for b in jfold.val_loaders[key]])
    if real and name.startswith("baseline"):
        _same(_batches(dm.test_loader(2)),
              [jax.device_get(b) for b in jdm.test_loader(2)])


def test_resident_and_host_batches_are_equal(tmp_path, monkeypatch):
    cfg = apply_overrides(get_experiment("smoke_synthetic_pretrain"),
                          PRETRAIN)
    cfg.output_dir = str(tmp_path)
    resident = next(build_datamodule(cfg, CPU).folds())
    monkeypatch.setenv(pipeline.RESIDENT_LIMIT_MB, "0")
    host = next(build_datamodule(cfg, CPU).folds())
    assert resident.train_loader.resident and not host.train_loader.resident
    state = host.train_loader.sampler.rng_state()
    init = (resident.train_loader.init_batch(),
            host.train_loader.init_batch())
    assert host.train_loader.sampler.rng_state() == state
    _same([{k: v.numpy() for k, v in init[0].items()}],
          [{k: v.numpy() for k, v in init[1].items()}])
    for _ in range(2):
        _same(_batches(resident.train_loader), _batches(host.train_loader))
    _same(_batches(resident.val_loaders["mura"]),
          _batches(host.val_loaders["mura"]))
    # a consumer that stops early leaves no producer behind
    it = iter(host.train_loader)
    next(it)
    it.close()


def test_pretrain_has_no_test_loader_and_downstream_counts_its_test_split(
        tmp_path):
    cfg = apply_overrides(get_experiment("smoke_synthetic_pretrain"),
                          PRETRAIN)
    cfg.output_dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="no test loader"):
        build_datamodule(cfg, CPU).test_loader(0)
    cfg = apply_overrides(get_experiment("baseline_only_imaging_resnet34"),
                          DOWNSTREAM)
    cfg.output_dir = str(tmp_path)
    dm = build_datamodule(cfg, CPU)
    test = _batches(dm.test_loader(1))
    assert sum(b["mask"].sum() for b in test) == len(dm.test) == 13
    assert dm.fold_statics(1).mean > 0
