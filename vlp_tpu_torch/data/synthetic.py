"""Synthetic fixture datasets so tests/CI never need MURA/LERA/BTXRD/INTERNAL
(the port's copy of ``vlp_tpu/data/synthetic.py``: byte-equal images and
equal sample dicts for a seed).

The reference has no such fixtures (its __main__ smoke blocks hit the real
data, SURVEY.md §4); here synthetic downstream/pretrain corpora with the
exact sample schema of the JAX package's vlp_tpu.data.datasets are generated procedurally:
random x-ray-like images (blobby gradients + noise) plus consistent clinical
metadata and caption assignments from the real caption CSV schema.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from vlp_tpu_torch.data import encoding
from vlp_tpu_torch.data.captions import DEFAULT_CAPTIONS_CSV, CaptionPool
from vlp_tpu_torch.data.preprocess_host import ImageCache, preprocess_image

Sample = Dict[str, object]

_PRETRAIN_SITES = (
    "ANKLE", "ELBOW", "FINGER", "FOOT", "FOREARM", "HAND", "HIP",
    "HUMERUS", "KNEE", "SHOULDER", "WRIST",
)


def synthetic_xray(rng: np.random.Generator, h: int = 96, w: int = 80,
                   tumor: bool = False) -> np.ndarray:
    """A crude radiograph-like uint8 image: dark background, bright bone-ish
    vertical band, optional blob ('tumor') so models can actually learn."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx = w / 2 + rng.normal(0, w * 0.05)
    band = np.exp(-((xx - cx) ** 2) / (2 * (w * 0.12) ** 2)) * 180
    img = band + rng.normal(0, 8, (h, w)).astype(np.float32) + 30
    if tumor:
        by = rng.uniform(h * 0.25, h * 0.75)
        bx = cx + rng.normal(0, w * 0.05)
        r = rng.uniform(min(h, w) * 0.06, min(h, w) * 0.14)
        blob = np.exp(-(((yy - by) ** 2 + (xx - bx) ** 2)) / (2 * r**2)) * 90
        img = img + blob
    return np.clip(img, 0, 255).astype(np.uint8)


def make_synthetic_downstream(
    num_samples: int = 64,
    image_size: int = 224,
    seed: int = 0,
    crop: bool = False,
) -> Tuple[List[Sample], ImageCache]:
    """Samples follow the downstream schema (dataset/tumor/clinical/...).
    Half INTERNAL half BTXRD so CORAL and per-dataset metrics exercise."""
    rng = np.random.default_rng(seed)
    sites = encoding.ANATOMY_SITES
    samples: List[Sample] = []
    images = np.zeros((num_samples, image_size, image_size), np.uint8)
    for i in range(num_samples):
        tumor = int(i % 2 == 0)
        dataset = "INTERNAL" if i % 4 < 2 else "BTXRD"
        site = sites[int(rng.integers(len(sites)))]
        sex = "F" if rng.random() < 0.5 else "M"
        age = int(rng.integers(5, 90))
        raw = synthetic_xray(rng, h=int(rng.integers(80, 120)),
                             w=int(rng.integers(64, 112)), tumor=bool(tumor))
        images[i] = preprocess_image(raw[:, :, None], image_size=image_size,
                                     crop=crop)
        samples.append({
            "dataset": dataset,
            "image_path": f"synthetic://downstream/{i}.png",
            "tumor": tumor,
            "entity": "synthetic" if tumor else "undefined",
            "anatomy_site": site,
            "clinical": encoding.clinical_vector(site, age, sex),
            "sex": sex,
            "sex_encoded": encoding.encode_sex(sex),
            "age": age,
            "age_encoded": int(encoding.encode_age(age)),
            "patient_number": f"P{i // 2}",
        })
    cache = ImageCache.from_arrays(images, [s["image_path"] for s in samples])
    return samples, cache


def make_synthetic_pretrain(
    num_samples: int = 64,
    image_size: int = 224,
    seed: int = 0,
    captions_csv: Optional[str] = None,
) -> Tuple[List[Sample], ImageCache]:
    """Samples follow the pretrain schema (label/caption/caption_id)."""
    pool = CaptionPool(captions_csv or DEFAULT_CAPTIONS_CSV)
    rng = np.random.default_rng(seed)
    samples: List[Sample] = []
    images = np.zeros((num_samples, image_size, image_size), np.uint8)
    sites = [s for s in _PRETRAIN_SITES if s in set(pool.sites())] or pool.sites()
    for i in range(num_samples):
        label = int(i % 2)
        site = sites[int(rng.integers(len(sites)))]
        caption, caption_id = pool.assign(site, label)
        raw = synthetic_xray(rng, h=int(rng.integers(80, 120)),
                             w=int(rng.integers(64, 112)), tumor=bool(label))
        images[i] = preprocess_image(raw[:, :, None], image_size=image_size)
        samples.append({
            "dataset": "MURA" if i % 2 == 0 else "LERA",
            "image_path": f"synthetic://pretrain/{i}.png",
            "label": label,
            "anatomy_site": site,
            "caption": caption,
            "caption_id": int(caption_id),
            "patient_id": f"P{i // 3}",
            "case_number": f"C{i // 3}",
        })
    cache = ImageCache.from_arrays(images, [s["image_path"] for s in samples])
    return samples, cache
