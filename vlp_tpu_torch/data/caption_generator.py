"""Offline caption-pool generator (the port's copy of the template path of
``vlp_tpu/data/caption_generator.py``, written with ``csv``).

The reference generates its caption pool (res/data/pretrain/captions.csv:
11 MURA/LERA sites x 2 labels x ~40 captions) with Llama-3.1-8B-Instruct
(reference src/data/helpers/caption_generator.py:7-88). Without model
weights the equivalent is a deterministic compositional template
generator with the same CSV schema (anatomy_site, abnormality_label,
caption) and the same pool sizes: the same rows and the same file bytes as
the JAX package's. Its LLM variant (``generate_with_llm``) needs an LLM's
weights and is not ported.

    python -m vlp_tpu_torch.data.caption_generator [out.csv]
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional

from vlp_tpu_torch.data.tables import isnan, read_csv, write_csv

SITES = (
    "ANKLE", "ELBOW", "FINGER", "FOOT", "FOREARM", "HAND", "HIP",
    "HUMERUS", "KNEE", "SHOULDER", "WRIST",
)
COLUMNS = ("anatomy_site", "abnormality_label", "caption")

_OPENERS = (
    "A radiograph of {art} {site}",
    "An x-ray image of {art} {site}",
    "Radiographic image of {art} {site}",
    "A plain film of {art} {site}",
    "An {site} x-ray",
    "A musculoskeletal radiograph of the {site}",
    "A diagnostic x-ray of the {site}",
    "A frontal radiograph of the {site}",
)

_NORMAL_FINDINGS = (
    "showing no signs of an abnormality.",
    "with no abnormal findings.",
    "with a normal appearance.",
    "demonstrating intact cortical margins and normal alignment.",
    "with preserved joint spaces and no acute osseous abnormality.",
    "showing normal bone density and trabecular pattern.",
    "without fracture, dislocation, or focal lesion.",
    "read as unremarkable by the interpreting radiologist.",
)

_ABNORMAL_FINDINGS = (
    "showing an abnormal finding.",
    "demonstrating a radiographic abnormality.",
    "with findings suspicious for pathology.",
    "showing cortical irregularity concerning for an osseous lesion.",
    "demonstrating abnormal bone texture and possible periosteal reaction.",
    "with an area of lucency that warrants further evaluation.",
    "showing degenerative or destructive osseous changes.",
    "flagged as abnormal on radiologic review.",
)


def _article(site: str) -> str:
    return "an" if site[0].lower() in "aeiou" else "a"


def generate_captions(per_combination: int = 40,
                      sites: Optional[List[str]] = None) -> List[Dict]:
    """Deterministic pool, as rows: per (site, label), cycle opener x
    finding combinations; 8 x 8 = 64 distinct combos cover
    per_combination=40."""
    rows = []
    for site in sites or SITES:
        site_l = site.lower()
        for label, findings in ((0, _NORMAL_FINDINGS),
                                (1, _ABNORMAL_FINDINGS)):
            combos = list(itertools.product(_OPENERS, findings))
            # interleave so neighbouring captions differ in both parts
            combos = combos[::3] + combos[1::3] + combos[2::3]
            seen = set()
            for opener, finding in combos:
                caption = (f"{opener.format(art=_article(site_l), site=site_l)}"
                           f" {finding}")
                caption = caption[0].upper() + caption[1:]
                if caption in seen:
                    continue
                seen.add(caption)
                rows.append({"anatomy_site": site, "abnormality_label": label,
                             "caption": caption})
                if len([r for r in rows
                        if r["anatomy_site"] == site
                        and r["abnormality_label"] == label]) \
                        >= per_combination:
                    break
    return rows


def fill_missing(csv_path: str, per_combination: int = 40) -> int:
    """Regenerate only missing (site,label) combinations in an existing
    caption CSV (the reference's caption_regenerate_missing.py:8-41), the
    file rewritten as pandas' ``concat`` + ``to_csv`` writes it. Returns the
    number of rows appended."""
    table = read_csv(csv_path)
    rows = list(table.rows())
    have = {(str(r["anatomy_site"]), int(r["abnormality_label"]))
            for r in rows}
    counts: Dict[tuple, int] = {}  # groupby(...).size(): NaN keys dropped
    for r in rows:
        key = (r["anatomy_site"], r["abnormality_label"])
        if not any(isnan(k) for k in key):
            counts[key] = counts.get(key, 0) + 1
    added = []
    full = generate_captions(per_combination)
    for site in SITES:
        for label in (0, 1):
            n_have = counts.get((site, label), 0)
            if (site, label) not in have or n_have < per_combination:
                existing = {r["caption"] for r in rows
                            if r["anatomy_site"] == site
                            and r["abnormality_label"] == label}
                for row in full:
                    if (row["anatomy_site"], row["abnormality_label"]) \
                            != (site, label):
                        continue
                    if len(existing) >= per_combination:
                        break
                    if row["caption"] not in existing:
                        added.append(row)
                        existing.add(row["caption"])
    if added:
        columns = table.columns + [c for c in COLUMNS
                                   if c not in table.columns]
        nan = float("nan")
        write_csv(csv_path, columns,
                  [[r.get(c, nan) for c in columns] for r in rows + added])
    return len(added)


def main(out_path: str = "res/data/pretrain/captions.csv",
         per_combination: int = 40) -> str:
    rows = generate_captions(per_combination)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    write_csv(out_path, COLUMNS, [[r[c] for c in COLUMNS] for r in rows])
    return out_path


if __name__ == "__main__":
    import sys

    path = main(*sys.argv[1:2])
    print(f"wrote {path}")
