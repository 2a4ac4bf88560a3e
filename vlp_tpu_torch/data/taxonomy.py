"""Shared anatomy-site taxonomy between INTERNAL and BTXRD (the port's
copy of ``vlp_tpu/data/taxonomy.py``).

Same mapping semantics as reference
src/data/helpers/internal_btxrd_combination.py:9-90 (mapping specified by
Yu Qiao in the reference): raw INTERNAL Latin labels and BTXRD multi-site
combinations map to the 13-category vocabulary of
:data:`vlp_tpu_torch.data.encoding.ANATOMY_SITES`.
"""
from __future__ import annotations

from typing import Sequence

_SITE_MAP = {
    "Clavicula": "shoulder",
    "Scapula": "shoulder",
    "shoulder-joint": "shoulder",
    "Humerus": "upper arm",
    "humerus": "upper arm",
    "humerus, shoulder-joint": "upper arm",
    "elbow-joint": "elbow",
    "Ulna": "lower arm",
    "ulna": "lower arm",
    "Radius": "lower arm",
    "radius": "lower arm",
    "ulna, radius": "lower arm",
    "hand, radius": "lower arm",
    "hand, ulna, radius": "lower arm",
    "hand": "hand",
    "wrist-joint": "hand",
    "Manus": "hand",
    "Columna vertebralis": "spine",
    "Os pubis": "hip",
    "Os ischii": "hip",
    "Os sacrum": "hip",
    "Os ilium": "hip",
    "hip-joint": "hip",
    "hip bone": "hip",
    "hip bone, hip-joint": "hip",
    "Femur": "upper leg",
    "femur": "upper leg",
    "femur, hip bone": "upper leg",
    "Patella": "knee",
    "knee-joint": "knee",
    "Tibia": "lower leg",
    "Fibula": "lower leg",
    "tibia": "lower leg",
    "fibula": "lower leg",
    "ankle-joint": "lower leg",
    "tibia, fibula": "lower leg",
    "foot, tibia, fibula": "lower leg",
    "Pes": "foot",
    "foot": "foot",
    "foot, ankle-joint": "foot",
    "tibia, fibula, femur": "leg",
    "tibia, femur": "leg",
    "fibula, femur": "leg",
    "tibia, fibula, femur, hip bone": "leg",
    "tibia, fibula, hip bone": "leg",
    "ulna, radius, humerus": "arm",
    "ulna, humerus": "arm",
    "radius, humerus": "arm",
}


def get_combined_anatomy_site_category(anatomy_sites: Sequence[str]) -> str:
    """Map raw site label(s) from either dataset to the shared 13-category
    taxonomy. BTXRD samples may carry multiple sites, joined with ', '."""
    if len(anatomy_sites) == 0:
        raise ValueError("Anatomy sites list cannot be empty.")
    key = ", ".join(anatomy_sites)
    if key not in _SITE_MAP:
        raise KeyError(f"Anatomy site {key!r} not found in taxonomy mapping.")
    return _SITE_MAP[key]
