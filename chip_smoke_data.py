"""Phase 27 of ``chip_smoke.py``: the real-data path (``data.name=
downstream|pretrain``) through the training entry point on the card, on a
corpus this phase writes in the INTERNAL, BTXRD, MURA and LERA layouts.
``chip_smoke.py`` runs ``phase_data`` after phase 26; under the launcher it
runs ``data_rank`` (``chip_smoke.py --data-rank <dir>``).

First #11 ``shear_rows`` and #12 ``add_gaussian_noise`` alone at the
shapes this path gives them ([64, 224, 224] and [128, 224, 224], both
axes, the warp's ramps and random shifts; noise at sigma 1) against their
plain versions with phase 5's bounds.

The corpus (``write_corpus``): 8-bit gray, RGB and RGBA PNGs (the numpy
writer ``data/png.write_png``: zlib, filter 0) with sides of 320-1024 pixels,
portrait and landscape; INTERNAL (tumours with Latin sites, numeric
patient numbers, German sex codes; healthy images), BTXRD (one-hot sites
and entities, healthy sites from their own table), MURA (train and valid
studies of its 7 sites) and LERA (cases of the other 4 of
``captions.csv``'s 11 sites); the frozen test splits of INTERNAL, BTXRD
and LERA written with the port's ``create_frozen_split``, their hashes
copied into each run's ``datacache``; ``*_DATASET_PATH`` set.

27a. ``python -m vlp_tpu_torch.train experiment=baseline_only_imaging_
     resnet34 trainer.max_epochs=1 test=true`` (``driver.main``, ResNet34,
     224, batch 64, shear and noise): 4 fold markers, ``test_eval.csv``
     with ``TEST_EVAL_HEADER``, 3 + 1 launches a train step; the image
     cache's build (host seconds, images/s, the C++ route) timed inside
     the run, then the same ``ImageCache.build`` again (the warm hit), and
     the NumPy route's cache of the same images (8 threads) against it:
     every image that differs by more than one uint8 step within the
     bound its histogram's bin-edge levels give (``bin_edge_bound``: the
     C++ route, the JAX package's, bins a level on an edge upwards).
27b. ``experiment=pretrain_resnet34_tinybert trainer.max_epochs=1
     k_fold_cross_validation=true`` (ResNet34 + TinyBERT, batch 128, all 5
     folds, where the experiment alone runs the first; the probe's
     downstream data the real INTERNAL + BTXRD): 5 fold markers, 3 + 1
     launches a step.
27c. The experiment's own command (its first fold) under
     ``python -m torch.distributed.run --nproc_per_node=<device_count>``
     into a fresh output directory: rank 0 builds the caches and writes
     MURA's test-set hash, the others open them after a barrier; each
     rank's launches 3 + 1 a step; every cache file and the hash
     byte-equal to 27b's.

Each run prints ``train/images_per_sec`` beside phase 21's synthetic run
of the same experiment, the launches of #11/#12 and the decoder used;
the numpy PNG reader is held against that decoder on every tenth image.
"""
from __future__ import annotations

import filecmp
import json
import os
import shutil
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from vlp_tpu_torch.data import preprocess_host
from vlp_tpu_torch.data.datasets import InternalDataset, LERADataset
# _chunk stays importable here: the tests build odd PNGs chunk by chunk
from vlp_tpu_torch.data.png import _chunk, write_png
from vlp_tpu_torch.data.splits import create_frozen_split
from vlp_tpu_torch.data.tables import write_csv
from vlp_tpu_torch.data.taxonomy import _SITE_MAP

SEED = 27
SIDES = (320, 1024)
DOWNSTREAM_IMAGES = 300
PRETRAIN_IMAGES = 450
HASHED = ("INTERNAL", "BTXRD", "LERA")
NUMPY_THREADS = 8
RANK_TIMEOUT = 600

_LATIN = sorted(k for k in _SITE_MAP if k[0].isupper())
_HEALTHY_SITES = ("shoulder", "upper arm", "elbow", "lower arm", "hand",
                  "hip", "upper leg", "knee", "lower leg", "foot")
_ENTITIES = ("osteochondroma", "enchondroma", "osteosarcoma",
             "giant cell tumor", "ewing sarcoma")
_BTXRD_SITES = ("hand", "ulna", "radius", "humerus", "foot", "tibia",
                "fibula", "femur", "hip bone", "ankle-joint", "knee-joint",
                "hip-joint", "wrist-joint", "elbow-joint", "shoulder-joint")
_BTXRD_TUMORS = ("osteochondroma", "multiple osteochondromas",
                 "simple bone cyst", "giant cell tumor", "osteofibroma",
                 "synovial osteochondroma", "other bt", "osteosarcoma",
                 "other mt")
MURA_SITES = ("ELBOW", "FINGER", "FOREARM", "HAND", "HUMERUS", "SHOULDER",
              "WRIST")
LERA_SITES = ("ANKLE", "FOOT", "HIP", "KNEE")


# --------------------------------------------------------------------------
# the corpus
# --------------------------------------------------------------------------

def radiograph(rng: np.random.Generator, h: int, w: int,
               channels: int = 1) -> np.ndarray:
    """A radiograph-like [H, W, channels] uint8 image: a bright bone-like
    ellipse over a ramp, with a little noise."""
    y = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :]
    cy, cx = rng.uniform(-0.3, 0.3, 2)
    ry, rx = rng.uniform(0.25, 0.8, 2)
    bone = np.exp(-2.0 * (((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2))
    gray = 30.0 + 170.0 * bone + 25.0 * x + rng.integers(0, 4, (h, w))
    gray = np.clip(gray, 0, 255).astype(np.uint8)
    if channels == 1:
        return gray[:, :, None]
    rgb = np.stack([gray, np.clip(gray.astype(np.int16) + 3, 0, 255),
                    np.clip(gray.astype(np.int16) - 2, 0, 255)], axis=2)
    if channels == 4:
        alpha = np.full((h, w, 1), 255, np.uint8)
        return np.concatenate([rgb.astype(np.uint8), alpha], axis=2)
    return rgb.astype(np.uint8)


class _Images:
    """Writes the corpus's PNGs on a pool of threads (zlib and numpy leave
    the interpreter lock): sides drawn from ``sides``, every 7th RGB and
    every 11th RGBA, the rest gray, each image from its own seed."""

    def __init__(self, rng, sides, threads: int = 8):
        from concurrent.futures import ThreadPoolExecutor

        self.rng, self.sides, self.count = rng, sides, 0
        self.channels = {1: 0, 3: 0, 4: 0}
        self.pool, self.jobs = ThreadPoolExecutor(threads), []

    def __call__(self, path: Path) -> None:
        h, w = (int(v) for v in self.rng.integers(self.sides[0],
                                                  self.sides[1] + 1, 2))
        c = 4 if self.count % 11 == 10 else 3 if self.count % 7 == 6 else 1
        seed = int(self.rng.integers(2 ** 31))
        path.parent.mkdir(parents=True, exist_ok=True)
        self.jobs.append(self.pool.submit(
            lambda: write_png(path, radiograph(np.random.default_rng(seed),
                                               h, w, c))))
        self.count += 1
        self.channels[c] += 1

    def wait(self) -> None:
        for job in self.jobs:
            job.result()
        self.jobs = []


def _internal(root: Path, n: int, image, rng, hashes: Path) -> None:
    tumors = []
    n_tumor = n * 3 // 5
    for i in range(n_tumor):
        name = f"t{i:04d}.png"
        image(root / "initial_images" / name)
        tumors.append((name, 1000 + i // 2, "W" if i % 3 else "M",
                       int(rng.integers(8, 80)),
                       _LATIN[i % len(_LATIN)], _ENTITIES[i % len(_ENTITIES)]))
    write_csv(str(root / "included_patients.csv"),
              ("image", "pat_nr", "sex", "age_initialdiagnosis",
               "anatomy_site", "entity"), tumors)
    healthy = []
    for i in range(n - n_tumor):
        path = root / "initial_images" / f"h{i:04d}.png"
        image(path)
        healthy.append((str(path), f"H{i // 2}", "F" if i % 2 else "M",
                        int(rng.integers(8, 80)),
                        _HEALTHY_SITES[i % len(_HEALTHY_SITES)]))
    write_csv(str(root / "healthy_subset_new_cleaned.csv"),
              ("file", "patient_id", "sex", "age", "anatomy_site"), healthy)
    reader = InternalDataset.__new__(InternalDataset)
    reader.path, reader.using_crops = str(root), False
    create_frozen_split(reader._parse(), str(root), stratify_keys=("tumor",),
                        group_key="patient_number", cache_dir=str(hashes),
                        dataset_name="INTERNAL")


def _btxrd(root: Path, n: int, image, rng, hashes: Path) -> None:
    rows, healthy, samples = [], [], []
    for i in range(n):
        name = f"b{i:04d}.png"
        image(root / "images" / name)
        tumor = i % 2
        sites = [int(tumor and j == i // 2 % len(_BTXRD_SITES))
                 for j in range(len(_BTXRD_SITES))]
        kinds = [int(tumor and j == i // 2 % len(_BTXRD_TUMORS))
                 for j in range(len(_BTXRD_TUMORS))]
        rows.append((name, tumor, "F" if i % 3 else "M",
                     int(rng.integers(5, 75)), *sites, *kinds))
        if not tumor:
            healthy.append((name, _HEALTHY_SITES[i // 2 % 10].title()))
        samples.append({"image_path": str(root / "images" / name),
                        "tumor": tumor})
    write_csv(str(root / "dataset.csv"), ("image_id", "tumor", "gender",
                                           "age", *_BTXRD_SITES,
                                           *_BTXRD_TUMORS), rows)
    write_csv(str(root / "BTXRD_healthy_anatomy_sites.csv"),
              ("image_file", "choice"), healthy)
    create_frozen_split(samples, str(root), stratify_keys=("tumor",),
                        cache_dir=str(hashes), dataset_name="BTXRD")


def _mura(root: Path, n: int, image) -> None:
    for split, patients, per in (("train", n * 9 // 10 // 3, 3),
                                 ("valid", n // 10 // 2, 2)):
        studies, paths = [], []
        offset = 0 if split == "train" else 50000
        for p in range(patients):
            site = MURA_SITES[p % len(MURA_SITES)]
            label = p // len(MURA_SITES) % 2
            study = (f"MURA-v1.1/{split}/XR_{site}/patient{offset + p:05d}/"
                     f"study1_{'positive' if label else 'negative'}/")
            studies.append((study, label))
            for k in range(per):
                paths.append((f"{study}image{k + 1}.png",))
                image(root / study.split("/", 1)[1] / f"image{k + 1}.png")
        with open(root / f"{split}_labeled_studies.csv", "w") as fh:
            fh.writelines(f"{s},{lbl}\n" for s, lbl in studies)
        with open(root / f"{split}_image_paths.csv", "w") as fh:
            fh.writelines(f"{p}\n" for (p,) in paths)


def _lera(root: Path, n: int, image, hashes: Path) -> None:
    labels = []
    for c in range(n // 5 * 2):
        case = f"case{c:04d}"
        for k in range(2 + c % 2):
            image(root / case / "ST-1" / f"image{k}.png")
        labels.append((case, f"XR {LERA_SITES[c % len(LERA_SITES)]}",
                       c // len(LERA_SITES) % 2))
    write_csv(str(root / "labels.csv"), ("case_number", "anatomy_site",
                                          "label"), labels)
    image.wait()  # the index lists the files
    reader = LERADataset.__new__(LERADataset)
    reader.path = str(root)
    create_frozen_split(reader._build_index(), str(root),
                        stratify_keys=("label",), group_key="case_number",
                        cache_dir=str(hashes), dataset_name="LERA")


def write_corpus(root: Path, downstream: int = DOWNSTREAM_IMAGES,
                 pretrain: int = PRETRAIN_IMAGES, sides=SIDES,
                 seed: int = SEED) -> dict:
    """The four datasets under ``root`` (about ``downstream`` INTERNAL +
    BTXRD and ``pretrain`` MURA + LERA images), their frozen test splits
    and hashes (``root/hashes``); returns ``{*_DATASET_PATH: root/<DS>}``
    and the images written by channels under ``"channels"``."""
    rng = np.random.default_rng(seed)
    image = _Images(rng, sides)
    hashes = root / "hashes"
    _internal(root / "INTERNAL", downstream // 2, image, rng, hashes)
    _btxrd(root / "BTXRD", downstream - downstream // 2, image, rng, hashes)
    _mura(root / "MURA", pretrain * 2 // 3, image)
    _lera(root / "LERA", pretrain - pretrain * 2 // 3, image, hashes)
    image.wait()
    image.pool.shutdown()
    env = {f"{name}_DATASET_PATH": str(root / name)
           for name in ("INTERNAL", "BTXRD", "MURA", "LERA")}
    return {**env, "channels": dict(image.channels), "images": image.count}


def seed_cache(root: Path, cache_dir: Path) -> None:
    """Copy the frozen splits' hashes into a run's cache directory, where
    the readers check them."""
    cache_dir.mkdir(parents=True, exist_ok=True)
    for name in HASHED:
        shutil.copy(root / "hashes" / f"{name}_test_set_hash.txt", cache_dir)


# --------------------------------------------------------------------------
# the phase
# --------------------------------------------------------------------------

def _check_path_kernels(stats: dict) -> None:
    """#11/#12 at this path's shapes against their plain versions with
    phase 5's bounds; the largest errors into ``stats``."""
    import chip_smoke as cs

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shear = noise = 0.0
    for b in (64, 128):
        img = torch.randint(0, 256, (b, 224, 224), generator=gen,
                            device="cuda").float()
        ms = cs.default_max_shift(224, 224)
        for kind in ("warp", "random"):
            for axis in (1, 0):
                shift = cs._shear_shift(gen, kind, b, 224, axis,
                                        ms).contiguous()
                out = cs.SH.shear_rows(img, shift, ms, axis)
                shear = max(shear, (out - cs.SH.shear_rows_plain(
                    img, shift, ms, axis)).abs().max().item())
        seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, 2), generator=gen,
                              device="cuda", dtype=torch.int32)
        ones = torch.ones(b, device="cuda")
        out = cs.NZ.add_gaussian_noise(img, seeds, ones)
        noise = max(noise, (out - cs.NZ.add_gaussian_noise_plain(
            img, seeds, ones)).abs().max().item())
    print(f"data: shear_rows at [64|128, 224, 224] (both axes, warp and "
          f"random shifts) max_abs vs plain {shear:.6g} (bound "
          f"{cs.BOUND_SHEAR:g}); add_gaussian_noise {noise:.6g} (bound "
          f"{cs.BOUND_NOISE:g})")
    cs.check(shear <= cs.BOUND_SHEAR and noise <= cs.BOUND_NOISE,
             "data: #11/#12 at the path's shapes")
    for name, err in (("shear_rows", shear), ("add_gaussian_noise", noise)):
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)


class _TimedBuilds:
    """Records each ``ImageCache.build`` of a run: images, host seconds,
    and whether the cache was already on disk."""

    def __init__(self):
        self.records, self._orig = [], None

    def __enter__(self):
        self._orig = orig = preprocess_host.ImageCache.build.__func__
        records = self.records

        def build(cls, paths, cache_dir, *args, **kwargs):
            t0, wall = time.perf_counter(), time.time()
            out = orig(cls, paths, cache_dir, *args, **kwargs)
            records.append({"images": len(paths),
                            "seconds": time.perf_counter() - t0,
                            "hit": os.path.getmtime(out.data.filename) < wall,
                            "cache": out})
            return out

        preprocess_host.ImageCache.build = classmethod(build)
        return self

    def __exit__(self, *exc):
        preprocess_host.ImageCache.build = classmethod(self._orig)


def bin_edge_bound(gray: np.ndarray) -> int:
    """The most two routes' equalised images may differ (in uint8 steps)
    where they bin the gray levels differently: the C++ route puts a level
    on a bin edge into the upper bin (``(x - lo) * 256 / (hi - lo)``
    truncated), ``np.histogram`` corrects against its float32 edges. The
    cumulative histograms, rescaled to [0, 255], then differ by at most
    max |delta|, which interpolation, padding and area resizing (convex
    combinations) carry through, plus one step of rounding."""
    flat = gray.reshape(-1)
    lo, hi = float(flat.min()), float(flat.max())
    if hi <= lo:
        return 1
    ours = np.bincount(np.minimum(((flat.astype(np.float64) - lo)
                                   * (256 / (hi - lo))).astype(np.int64),
                                  255), minlength=256)
    theirs = np.histogram(flat, bins=256)[0]

    def rescaled(counts):
        cum = np.cumsum(counts).astype(np.float64)
        return (cum - cum[0]) / (cum[-1] - cum[0]) * 255.0

    return int(np.floor(np.abs(rescaled(ours) - rescaled(theirs)).max()
                        + 1.0 + 1e-3))


def _png_route(smi: str, paths, every: int = 10) -> None:
    """The numpy PNG reader against ``decode_image`` on every
    ``every``-th corpus image (cv2 or PIL where installed)."""
    import chip_smoke as cs
    from vlp_tpu_torch.data.png import read_png

    picked = paths[::every]
    t0 = time.perf_counter()
    for p in picked:
        cs.check(np.array_equal(read_png(p), preprocess_host.decode_image(p)),
                 f"data: the PNG reader differs from "
                 f"{preprocess_host.decoder()} on {p}")
    print(f"data: the numpy PNG reader equals {preprocess_host.decoder()} on "
          f"{len(picked)} corpus images ({(time.perf_counter() - t0):.2f} s);"
          f" on {smi}")


def _main(argv) -> tuple:
    """``python -m vlp_tpu_torch.train`` in this process
    (``driver.main``), the launch counts set to 0 just before it and read
    just after; returns (launches, seconds, builds)."""
    import chip_smoke as cs
    from vlp_tpu_torch.train import driver

    torch.cuda.synchronize()
    cs._reset_counts()
    t0 = time.perf_counter()
    with _TimedBuilds() as builds:
        cs.check(driver.main(list(argv)) == 0, f"data: {argv} failed")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return ({k: v for k, v in cs._counts().items() if v}, seconds,
            builds.records)


def _steps_and_rates(out: Path, folds: int) -> tuple:
    import chip_smoke as cs

    markers = sorted(p.name for p in out.glob("fold*.done.json"))
    cs.check(markers == [f"fold{i}.done.json" for i in range(folds)],
             f"data {out.name}: fold markers {markers}")
    records = [cs._records(out, i) for i in range(folds)]
    steps = sum(r[-1]["_step"] for r in records)
    return steps, [r[0]["train/images_per_sec"] for r in records]


def _synthetic_rate(path: Path) -> str:
    """Epoch 0's images/s of phase 21's synthetic run, by fold."""
    files = sorted(path.glob("metrics_fold*.jsonl"))
    if not files:
        return "not run in this call"
    rates = [json.loads(f.read_text().splitlines()[0])[
        "train/images_per_sec"] for f in files]
    return f"median {statistics.median(rates):.1f} ({len(rates)} folds)"


def _describe(builds) -> str:
    return "; ".join(
        f"{b['images']} images {'hit' if b['hit'] else 'built'} in "
        f"{b['seconds']:.3f} s ({b['images'] / b['seconds']:.1f} images/s)"
        for b in builds)


def _downstream(smi: str, root: Path, data: Path) -> dict:
    import chip_smoke as cs

    out = root / "data_downstream"
    seed_cache(data, out / "datacache")
    launches, seconds, builds = _main([
        "--device", "cuda", f"experiment={cs.RESNET34}",
        "trainer.max_epochs=1", "test=true", f"output_dir={out}"])
    steps, rates = _steps_and_rates(out, 4)
    cs._augment_launches(launches, steps, "27a")
    header = (out / "test_eval.csv").read_text().splitlines()[0]
    cs.check(header == cs.TEST_EVAL_HEADER, f"27a: test_eval.csv header "
             f"{header!r}")
    built = [b for b in builds if not b["hit"]]
    cs.check(len(built) == 1, f"27a: cache builds {builds}")
    build = built[0]
    print(f"data 27a {cs.RESNET34}: 4 folds x 1 epoch + test=true in "
          f"{seconds:.1f} s, {steps} train steps, launches {launches}; "
          f"train/images_per_sec by fold {[round(r, 1) for r in rates]} "
          f"(phase 21a synthetic epoch 0: "
          f"{_synthetic_rate(root / 'resnet34')}); test_eval.csv "
          f"{len((out / 'test_eval.csv').read_text().splitlines()) - 1} "
          f"rows; image cache (C++ route, one thread): {_describe(builds)};"
          f" {cs._epoch_split(out, 4, seconds)}; on {smi}")
    cache = build["cache"]
    cfg = cs.get_experiment(cs.RESNET34).data
    kwargs = dict(image_size=cfg.image_size, crop=cfg.crop_larger_dimension,
                  maximum_crop_ratio=cfg.maximum_crop_ratio)
    t0 = time.perf_counter()
    warm = preprocess_host.ImageCache.build(cache.paths,
                                            str(out / "datacache"), **kwargs)
    warm_s = time.perf_counter() - t0
    cs.check(np.array_equal(np.asarray(warm.data), np.asarray(cache.data)),
             "27a: the warm cache differs")
    t0 = time.perf_counter()
    plain = preprocess_host.ImageCache.build(
        cache.paths, str(root / "data_numpy_cache"), use_native=False,
        num_workers=NUMPY_THREADS, **kwargs)
    plain_s = time.perf_counter() - t0
    diff = np.abs(np.asarray(plain.data, np.int16)
                  - np.asarray(cache.data, np.int16)).reshape(len(cache), -1)
    worst = diff.max(axis=1)
    wide = np.flatnonzero(worst > 1)
    for i in wide:  # each explained by the C++ route's histogram bins
        bound = bin_edge_bound(preprocess_host.to_grayscale(
            preprocess_host.decode_image(cache.paths[i])))
        cs.check(worst[i] <= bound, f"27a: image {cache.paths[i]}: the "
                 f"routes differ by {worst[i]} steps, more than the "
                 f"{bound} its histogram bins explain")
    print(f"data 27a: the same ImageCache.build again: a hit in "
          f"{warm_s * 1e3:.1f} ms; the NumPy route's cache of the "
          f"{len(cache)} images ({NUMPY_THREADS} threads, "
          f"{plain_s:.2f} s, {len(cache) / plain_s:.1f} images/s) vs the "
          f"C++ route's: max |diff| {int(worst.max())} uint8 step(s), "
          f"{int((diff > 0).sum())} of {diff.size} pixels differ, "
          f"{int((diff > 1).sum())} by more than one step, in {len(wide)} "
          f"images, each within the bound its histogram's bin-edge levels "
          f"give (bin_edge_bound); on {smi}")
    return launches


def _pretrain(smi: str, root: Path, data: Path) -> dict:
    import chip_smoke as cs

    out = root / "data_pretrain"
    seed_cache(data, out / "datacache")
    launches, seconds, builds = _main([
        "--device", "cuda", f"experiment={cs.PRETRAIN}",
        "trainer.max_epochs=1", "k_fold_cross_validation=true",
        f"output_dir={out}"])
    steps, rates = _steps_and_rates(out, 5)
    cs._augment_launches(launches, steps, "27b")
    print(f"data 27b {cs.PRETRAIN}: 5 folds x 1 epoch in {seconds:.1f} s, "
          f"{steps} train steps, launches {launches}; train/images_per_sec "
          f"by fold {[round(r, 1) for r in rates]} (phase 21b synthetic: "
          f"{_synthetic_rate(root / 'vlp' / 'pretrain')}); image caches "
          f"(pretrain, then the probe's downstream): {_describe(builds)}; "
          f"{cs._epoch_split(out, 5, seconds)}; on {smi}")
    return launches


def data_rank(out: Path) -> int:
    """27c's rank program (under the launcher): ``driver.main`` of the
    arguments in ``out/argv.json``; this rank's launches as
    ``launches_rank<r>.json``."""
    import logging

    logging.getLogger("vlp_tpu_torch").setLevel(logging.WARNING)
    argv = json.loads((out / "argv.json").read_text())
    launches, seconds, builds = _main(argv)
    rank = int(os.environ.get("RANK", "0"))
    (out / f"launches_rank{rank}.json").write_text(json.dumps({
        "launches": launches, "seconds": seconds,
        "builds": [{k: b[k] for k in ("images", "seconds", "hit")}
                   for b in builds]}))
    return 0


def _dp_pretrain(smi: str, root: Path, data: Path) -> dict:
    import chip_smoke as cs

    world = torch.cuda.device_count()
    out = root / "data_pretrain_dp"
    seed_cache(data, out / "datacache")
    (out / "argv.json").write_text(json.dumps([
        "--device", "cuda", f"experiment={cs.PRETRAIN}",
        "trainer.max_epochs=1", "k_fold_cross_validation=false",
        f"output_dir={out}"]))
    _, seconds = cs._launch([str(Path(cs.__file__).resolve()),
                             "--data-rank", str(out)], world, RANK_TIMEOUT,
                            "27c")
    steps, rates = _steps_and_rates(out, 1)
    ranks = [json.loads((out / f"launches_rank{r}.json").read_text())
             for r in range(world)]
    for r, rank in enumerate(ranks):
        cs._augment_launches(rank["launches"], steps, f"27c rank {r}")
        hits = [b["hit"] for b in rank["builds"]]
        cs.check(hits == ([False, False] if r == 0 else [True, True]),
                 f"27c rank {r}: cache builds {rank['builds']} (rank 0 "
                 "builds, the others open)")
    single = sorted(p.name for p in (root / "data_pretrain" / "datacache")
                    .glob("imgcache_*"))
    mine = sorted(p.name for p in (out / "datacache").glob("imgcache_*"))
    cs.check(mine == single and all(filecmp.cmp(
        root / "data_pretrain" / "datacache" / name, out / "datacache" / name,
        shallow=False) for name in mine + ["MURA_test_set_hash.txt"]),
        f"27c: caches {mine} vs 27b's {single}")
    print(f"data 27c {cs.PRETRAIN} under the launcher, W={world}, 1 fold: "
          f"{seconds:.1f} s (launch included), {steps} train steps, "
          f"launches a rank {[rk['launches'] for rk in ranks]}, "
          f"train/images_per_sec {rates[0]:.1f}; rank 0 built "
          f"{_describe(ranks[0]['builds'])}; the other ranks opened them "
          f"after the barrier; the {len(mine)} cache files and MURA's hash "
          f"byte-equal to 27b's; on {smi}")
    return ranks[0]["launches"]


def phase_data(smi: str, root: Path, stats: dict) -> dict:
    """Phase 27. Returns the launches of each run (27c: rank 0's)."""
    import chip_smoke as cs

    t0 = time.perf_counter()
    cs._quiet_trainer_logs()
    _check_path_kernels(stats)
    data = root / "data"
    t_write = time.perf_counter()
    env = write_corpus(data)
    t_write = time.perf_counter() - t_write
    channels = env.pop("channels")
    images = env.pop("images")
    os.environ.update(env)
    print(f"data: wrote {images} PNGs (gray {channels[1]}, RGB "
          f"{channels[3]}, RGBA {channels[4]}; sides {SIDES[0]}-{SIDES[1]})"
          f" in the INTERNAL, BTXRD, MURA and LERA layouts in "
          f"{t_write:.1f} s; decoder {preprocess_host.decoder()}")
    _png_route(smi, sorted(str(p) for p in data.rglob("*.png")))
    paths = {"data_downstream_trainer": _downstream(smi, root, data),
             "data_pretrain_trainer": _pretrain(smi, root, data)}
    paths["dp_data_pretrain_trainer"] = _dp_pretrain(smi, root, data)
    print(f"phase 27: {time.perf_counter() - t0:.1f} s")
    return paths
