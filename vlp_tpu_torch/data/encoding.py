"""Clinical metadata encodings (the port's copy of
``vlp_tpu/data/encoding.py``).

Same semantics as reference src/data/helpers/encoding.py:4-56 but as numpy
(host-side manifest building); the 15-dim clinical vector fed to the fusion
MLP is concat(one-hot site[13], age_bin[1], sex[1])
(reference FusionModule.py:326).
"""
from __future__ import annotations

import numpy as np

ANATOMY_SITES = (
    "shoulder",
    "arm",
    "upper arm",
    "elbow",
    "lower arm",
    "hand",
    "spine",
    "hip",
    "leg",
    "upper leg",
    "knee",
    "lower leg",
    "foot",
)

NUM_ANATOMY_SITES = len(ANATOMY_SITES)
CLINICAL_DIM = NUM_ANATOMY_SITES + 2  # + age bin + sex


def encode_sex(sex: str) -> float:
    if sex not in ("F", "M"):
        raise ValueError(f"Sex must be 'F' or 'M', got {sex!r}")
    return 1.0 if sex == "F" else 0.0


def encode_age(age: int) -> float:
    """Ten-year bins; 60+ all map to bin 7 (reference encoding.py:11-31)."""
    if age < 0:
        raise ValueError(f"Age must be non-negative, got {age}")
    return float(min(int(age) // 10 + 1, 7))


def encode_anatomy_site(anatomy_site: str) -> np.ndarray:
    if anatomy_site not in ANATOMY_SITES:
        raise ValueError(
            f"Anatomy site must be one of {ANATOMY_SITES}, got {anatomy_site!r}"
        )
    onehot = np.zeros(NUM_ANATOMY_SITES, dtype=np.float32)
    onehot[ANATOMY_SITES.index(anatomy_site)] = 1.0
    return onehot


def clinical_vector(anatomy_site: str, age: int, sex: str) -> np.ndarray:
    """The 15-dim late-fusion input: [site one-hot(13), age_bin, sex]."""
    return np.concatenate(
        [
            encode_anatomy_site(anatomy_site),
            np.array([encode_age(age)], dtype=np.float32),
            np.array([encode_sex(sex)], dtype=np.float32),
        ]
    ).astype(np.float32)
