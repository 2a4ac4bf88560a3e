"""The real datasets' readers: INTERNAL, BTXRD, MURA, LERA (the port's
copy of ``vlp_tpu/data/datasets.py``, its tables read and written with
``data/tables.py`` in place of pandas).

Host-side parsing into plain sample dicts with the same schema, split
semantics and quirks as the reference dataset classes (src/data/{INTERNAL,
BTXRD,MURA,LERA}Dataset.py). Dataset roots come from the reference's
environment variables (README.md:357-376): INTERNAL_DATASET_PATH,
BTXRD_DATASET_PATH, MURA_DATASET_PATH, LERA_DATASET_PATH. An ``.xlsx``
table is read through its same-named ``.csv`` twin: no Excel reader is
installed beside the port.

Sample schema (downstream): dataset, image_path, tumor, entity,
anatomy_site, clinical (15-dim float32 vector), sex, sex_encoded, age,
age_encoded, patient_number (split-only).
Sample schema (pretrain): dataset, image_path, label, anatomy_site, caption,
caption_id, patient_id/case_number (split-only).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from vlp_tpu_torch.data import encoding
from vlp_tpu_torch.data.captions import CaptionPool
from vlp_tpu_torch.data.splits import (DOWNSTREAM_STRATIFY, PRETRAIN_STRATIFY,
                                       assert_no_group_leakage,
                                       btxrd_stratify_label,
                                       check_test_set_hash, cv_splits,
                                       load_frozen_split, save_test_set_hash)
from vlp_tpu_torch.data.tables import Table, read_csv, write_csv
from vlp_tpu_torch.data.taxonomy import get_combined_anatomy_site_category

Sample = Dict[str, object]

ENV_PATHS = {
    "INTERNAL": "INTERNAL_DATASET_PATH",
    "BTXRD": "BTXRD_DATASET_PATH",
    "MURA": "MURA_DATASET_PATH",
    "LERA": "LERA_DATASET_PATH",
}


def read_table(path: str) -> Table:
    """An ``.xlsx`` table through its same-named ``.csv`` twin (the JAX
    package reads it so when no Excel engine is installed); any other path
    as a CSV. Raises as the JAX package does without an Excel engine:
    ``RuntimeError`` where the workbook has no twin, ``FileNotFoundError``
    where neither exists."""
    base, ext = os.path.splitext(path)
    csv_path = base + ".csv"
    if ext == ".xlsx":
        if os.path.exists(csv_path):
            return read_csv(csv_path)
        if os.path.exists(path):
            raise RuntimeError(
                f"cannot read {path}: no Excel engine installed and no CSV "
                f"fallback at {csv_path}")
        raise FileNotFoundError(path)
    return read_csv(path)


def dataset_path(name: str, override: Optional[str] = None) -> str:
    if override:
        return override
    env = ENV_PATHS[name]
    path = os.environ.get(env)
    if not path:
        raise EnvironmentError(
            f"Set {env} to the {name} dataset root (reference "
            "README.md:357-376).")
    return path


def _downstream_sample(dataset: str, image_path: str, tumor: int,
                       entity: str, anatomy_site: str, sex: str, age: int,
                       patient: object) -> Sample:
    return {
        "dataset": dataset,
        "image_path": str(image_path),
        "tumor": int(tumor),
        "entity": entity,
        "anatomy_site": anatomy_site,
        "clinical": encoding.clinical_vector(anatomy_site, int(age), sex),
        "sex": sex,
        "sex_encoded": encoding.encode_sex(sex),
        "age": int(age),
        "age_encoded": int(encoding.encode_age(int(age))),
        "patient_number": str(patient),
    }


# --------------------------------------------------------------------------
# INTERNAL
# --------------------------------------------------------------------------

class InternalDataset:
    """Reference src/data/INTERNALDataset.py.

    Tumor patients from included_patients.xlsx (all tumor=1); healthy from
    healthy_subset_new_cleaned.csv (tumor=0). German 'W' -> 'F'
    (INTERNALDataset.py:143). Frozen test split via test_set_split.csv
    (raises if absent); CV = StratifiedGroupKFold(4, seed 42) grouped by
    patient (INTERNALDataset.py:242-273).
    """

    name = "INTERNAL"
    cv_group_key = "patient_number"
    # joint (tumor, anatomy_site) stratification (INTERNALDataset.py:259)
    cv_stratify = DOWNSTREAM_STRATIFY

    def __init__(self, path: Optional[str] = None, using_crops: bool = False,
                 cache_dir: Optional[str] = None) -> None:
        self.path = dataset_path("INTERNAL", path)
        self.using_crops = using_crops
        samples = self._parse()
        self.train_val, self.test = load_frozen_split(
            samples, self.path, cache_dir=cache_dir, dataset_name=self.name)
        assert_no_group_leakage(self.train_val, self.test, "patient_number")

    def _parse(self) -> List[Sample]:
        tumors = read_table(os.path.join(self.path, "included_patients.xlsx"))
        samples: List[Sample] = []
        img_dir = ("images_bounding_box_15_500_BILINEAR"
                   if self.using_crops else "initial_images")
        for row in tumors.rows():
            sex = "F" if row["sex"] == "W" else row["sex"]
            samples.append(_downstream_sample(
                "INTERNAL", os.path.join(self.path, img_dir, row["image"]),
                tumor=1, entity=str(row.get("entity", "undefined")),
                anatomy_site=get_combined_anatomy_site_category(
                    [str(row["anatomy_site"])]),
                sex=sex, age=row["age_initialdiagnosis"],
                patient=row["pat_nr"]))
        healthy = read_csv(
            os.path.join(self.path, "healthy_subset_new_cleaned.csv"))
        for row in healthy.rows():
            samples.append(_downstream_sample(
                "INTERNAL", row["file"], tumor=0, entity="undefined",
                anatomy_site=row["anatomy_site"], sex=row["sex"],
                age=row["age"], patient=row["patient_id"]))
        return samples

    def cv_folds(self, n_splits: int = 4, seed: int = 42):
        return cv_splits(self.train_val, n_splits=n_splits,
                         stratify_keys=self.cv_stratify,
                         group_key=self.cv_group_key, seed=seed)


# --------------------------------------------------------------------------
# BTXRD
# --------------------------------------------------------------------------

_BTXRD_TUMOR_TYPES = (
    "osteochondroma", "multiple osteochondromas", "simple bone cyst",
    "giant cell tumor", "osteofibroma", "synovial osteochondroma",
    "other bt", "osteosarcoma", "other mt",
)
_BTXRD_SITES = (
    "hand", "ulna", "radius", "humerus", "foot", "tibia", "fibula", "femur",
    "hip bone", "ankle-joint", "knee-joint", "hip-joint", "wrist-joint",
    "elbow-joint", "shoulder-joint",
)


class BTXRDDataset:
    """Reference src/data/BTXRDDataset.py.

    dataset.xlsx has 9 one-hot tumor-type columns and 15 one-hot site
    columns; healthy-sample sites come from BTXRD_healthy_anatomy_sites.xlsx
    ('choice' lower-cased, BTXRDDataset.py:127). CV = StratifiedKFold(4,
    seed 42), no grouping (BTXRDDataset.py:208-235).
    """

    name = "BTXRD"
    cv_group_key = None
    # (tumor, site-or-'undefined-for-healthy') (BTXRDDataset.py:227-229)
    cv_stratify_fn = staticmethod(btxrd_stratify_label)

    def __init__(self, path: Optional[str] = None,
                 healthy_sites_xlsx: Optional[str] = None,
                 cache_dir: Optional[str] = None) -> None:
        self.path = dataset_path("BTXRD", path)
        self.healthy_sites_xlsx = healthy_sites_xlsx or os.path.join(
            self.path, "BTXRD_healthy_anatomy_sites.xlsx")
        samples = self._parse()
        self.train_val, self.test = load_frozen_split(
            samples, self.path, cache_dir=cache_dir, dataset_name=self.name)

    def _parse(self) -> List[Sample]:
        table = read_table(os.path.join(self.path, "dataset.xlsx"))
        healthy_sites = read_table(self.healthy_sites_xlsx)
        site_by_image = dict(zip(healthy_sites["image_file"],
                                 healthy_sites.lower("choice")))
        samples: List[Sample] = []
        for row in table.rows():
            if int(row["tumor"]) == 0:
                site = str(site_by_image[row["image_id"]])
            else:
                onehot = [s for s in _BTXRD_SITES if int(row.get(s, 0)) == 1]
                site = get_combined_anatomy_site_category(onehot)
            entity = next(
                (t for t in _BTXRD_TUMOR_TYPES if int(row.get(t, 0)) == 1),
                "undefined")
            samples.append(_downstream_sample(
                "BTXRD", os.path.join(self.path, "images", row["image_id"]),
                tumor=int(row["tumor"]), entity=entity, anatomy_site=site,
                sex=row["gender"], age=row["age"], patient=row["image_id"]))
        return samples

    def cv_folds(self, n_splits: int = 4, seed: int = 42):
        return cv_splits(self.train_val, n_splits=n_splits,
                         stratify_fn=self.cv_stratify_fn,
                         group_key=None, seed=seed)


# --------------------------------------------------------------------------
# MURA (pretrain)
# --------------------------------------------------------------------------

class MURADataset:
    """Reference src/data/MURADataset.py.

    Parses MURA-v1.1 CSV pairs ({train,valid}_labeled_studies.csv,
    *_image_paths.csv); anatomy site = segment after 'XR_'; patient/study ids
    from the path. The official valid split is the TEST set, its hash
    written to <cache_dir>/MURA_test_set_hash.txt on the first run and
    checked on every later one (MURADataset.py:248-257). CV =
    StratifiedGroupKFold(5, seed 42) on train, grouped by patient.
    """

    name = "MURA"
    cv_group_key = "patient_id"
    # joint (label, anatomy_site) stratification (MURADataset.py:272)
    cv_stratify = PRETRAIN_STRATIFY

    def __init__(self, caption_pool: CaptionPool, path: Optional[str] = None,
                 cache_dir: str = "datacache") -> None:
        self.path = dataset_path("MURA", path)
        self.captions = caption_pool
        self.train_val, self.test = self._parse()
        hash_file = os.path.join(cache_dir, f"{self.name}_test_set_hash.txt")
        test_paths = [s["image_path"] for s in self.test]
        if os.path.exists(hash_file):
            check_test_set_hash(test_paths, cache_dir, self.name)
        else:
            save_test_set_hash(test_paths, cache_dir, self.name)

    def _parse(self) -> Tuple[List[Sample], List[Sample]]:
        out = []
        for split in ("train", "valid"):
            labels = read_csv(
                os.path.join(self.path, f"{split}_labeled_studies.csv"),
                names=("study_path", "label"))
            images = read_csv(
                os.path.join(self.path, f"{split}_image_paths.csv"),
                names=("rel_path",))
            label_by_study = dict(zip(labels["study_path"], labels["label"]))
            samples: List[Sample] = []
            for rel in images["rel_path"]:
                site = rel.split("XR_")[1].split("/")[0]
                patient_id = rel.split("patient")[1].split("/")[0]
                study_path = "/".join(rel.split("/")[:-1]) + "/"
                label = int(label_by_study[study_path])
                # rel starts with 'MURA-v1.1/'; the root already includes it
                local = os.path.join(*rel.split("/")[1:])
                caption, caption_id = self.captions.assign(site, label)
                samples.append({
                    "dataset": "MURA",
                    "image_path": os.path.join(self.path, local),
                    "label": label,
                    "anatomy_site": site,
                    "caption": caption,
                    "caption_id": int(caption_id),
                    "patient_id": str(patient_id),
                })
            out.append(samples)
        return out[0], out[1]

    def cv_folds(self, n_splits: int = 5, seed: int = 42):
        return cv_splits(self.train_val, n_splits=n_splits,
                         stratify_keys=self.cv_stratify,
                         group_key=self.cv_group_key, seed=seed)


# --------------------------------------------------------------------------
# LERA (pretrain)
# --------------------------------------------------------------------------

INDEX_COLUMNS = ("image_path", "case_number", "anatomy_site", "label")


class LERADataset:
    """Reference src/data/LERADataset.py.

    Builds/loads dataset.csv by walking <case>/ST-1/*.png + labels.csv; site
    string strips the 'XR ' prefix (LERADataset.py:160). Frozen test split
    via test_set_split.csv; CV = StratifiedGroupKFold(5, seed 42) grouped by
    case_number. The first run parses the index it built, later runs the
    index read back from dataset.csv, as the JAX package does.
    """

    name = "LERA"
    cv_group_key = "case_number"
    # joint (label, anatomy_site) stratification (LERADataset.py:255)
    cv_stratify = PRETRAIN_STRATIFY

    def __init__(self, caption_pool: CaptionPool, path: Optional[str] = None,
                 cache_dir: Optional[str] = None) -> None:
        self.path = dataset_path("LERA", path)
        self.captions = caption_pool
        samples = self._parse()
        self.train_val, self.test = load_frozen_split(
            samples, self.path, cache_dir=cache_dir, dataset_name=self.name)
        assert_no_group_leakage(self.train_val, self.test, "case_number")

    def _parse(self) -> List[Sample]:
        index_csv = os.path.join(self.path, "dataset.csv")
        if os.path.exists(index_csv):
            rows = list(read_csv(index_csv).rows())
        else:
            rows = self._build_index()
            write_csv(index_csv, INDEX_COLUMNS if rows else (),
                      [[r[c] for c in INDEX_COLUMNS] for r in rows])
        samples: List[Sample] = []
        for row in rows:
            site = str(row["anatomy_site"]).removeprefix("XR ")
            label = int(row["label"])
            caption, caption_id = self.captions.assign(site, label)
            samples.append({
                "dataset": "LERA",
                "image_path": str(row["image_path"]),
                "label": label,
                "anatomy_site": site,
                "caption": caption,
                "caption_id": int(caption_id),
                "case_number": str(row["case_number"]),
            })
        return samples

    def _build_index(self) -> List[dict]:
        labels = read_csv(os.path.join(self.path, "labels.csv"))
        rows = []
        for lrow in labels.rows():
            case = str(lrow["case_number"]) if "case_number" in lrow \
                else str(lrow[labels.columns[0]])
            case_dir = os.path.join(self.path, case, "ST-1")
            if not os.path.isdir(case_dir):
                continue
            for fname in sorted(os.listdir(case_dir)):
                if fname.endswith(".png"):
                    rows.append({
                        "image_path": os.path.join(case_dir, fname),
                        "case_number": case,
                        "anatomy_site": lrow.get("anatomy_site",
                                                 lrow.get("site")),
                        "label": lrow["label"],
                    })
        return rows

    def cv_folds(self, n_splits: int = 5, seed: int = 42):
        return cv_splits(self.train_val, n_splits=n_splits,
                         stratify_keys=self.cv_stratify,
                         group_key=self.cv_group_key, seed=seed)
