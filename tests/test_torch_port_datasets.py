"""The port's real-data readers (``vlp_tpu_torch/data/tables.py``,
``datasets.py``, ``splits.py``'s frozen split, ``png.py``,
``preprocess_host.ImageCache.build``) against pandas and the JAX package,
on the CPU, over fixture trees in the corpora's layouts (those of
``tests/test_real_parsers.py``, widened with numeric patient numbers, a
missing one and an empty entity) made with numpy from a seed.

Every comparison is exact: cells, sample dicts and folds equal; the
frozen-split CSV, the hashes, LERA's index and the image caches' files
byte-equal; the PNG reader's pixels equal to cv2's.
"""
import filecmp
import math
import os
import shutil
import struct
import zipfile
import zlib

import cv2
import numpy as np
import pandas as pd
import pytest

from vlp_tpu.data import datasets as jds
from vlp_tpu.data import preprocess_host as jph
from vlp_tpu.data import splits as jsplits
from vlp_tpu.data.captions import CaptionPool as JPool
from vlp_tpu_torch.data import datasets, preprocess_host, splits, tables
from vlp_tpu_torch.data.captions import CaptionPool
from vlp_tpu_torch.data.png import PNGError, read_png

import chip_smoke_data


# --------------------------------------------------------------------------
# the CSV reader and writer against pandas
# --------------------------------------------------------------------------

TABLES = {
    "numeric_ids": "pat_nr,image,age\n12,a.png,30\n7,b.png,41\n300,c.png,5\n",
    "int_with_gap": "pat_nr,image\n12,a.png\n,b.png\n3,c.png\n",
    "empty_strings": "entity,site,sex\nosteoma,Femur,M\n,Tibia,\n\"\",Pes,W\n",
    "bools": "image_path,is_test\nx/a.png,True\nx/b.png,False\n",
    "bools_with_gap": "path,flag\na,True\nb,\nc,FALSE\n",
    "quoted": ('file,caption\n"a,b.png","one, two"\n'
               'c.png,"say ""hi"""\n"d\ne.png",plain\n'),
    "na_tokens": "a,b\nNA,x\nnull,N/A\n1.5,None\n",
    "floats": "a,b,c\n1.5,inf,1e3\n-2,-Inf,.5\n3,2.,7\n",
    "all_numeric": "case,label,score\n1,0,0.5\n2,1,\n3,0,1.25\n",
    "all_int": "case,label\n1,0\n2,1\n",
    "spaces_and_blank_lines": "a,b\n 1 ,x\n\n2, y\n\n",
    "mixed": "a,b\n1,True\nx,1\n",
}


def _same_cell(a, b) -> bool:
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    return type(a) is type(b.item() if isinstance(b, np.generic) else b) \
        and a == b


@pytest.mark.parametrize("name", sorted(TABLES))
def test_csv_reader_matches_pandas_cell_by_cell(name, tmp_path):
    path = tmp_path / f"{name}.csv"
    path.write_text(TABLES[name])
    want = pd.read_csv(path)
    got = tables.read_csv(str(path))
    assert got.columns == list(want.columns) and len(got) == len(want)
    for col in want.columns:
        for a, b in zip(got[col], want[col].tolist()):
            assert _same_cell(a, b), (col, a, b)
    for row, (_, want_row) in zip(got.rows(), want.iterrows()):
        for col in want.columns:
            a, b = row[col], want_row[col]
            assert str(a) == str(b) and _same_cell(a, b), (col, a, b)


def test_csv_reader_without_a_header_and_the_str_accessor(tmp_path):
    path = tmp_path / "studies.csv"
    path.write_text("MURA-v1.1/train/XR_HAND/patient1/study1_positive/,1\n"
                    "MURA-v1.1/train/XR_HAND/patient2/study1_negative/,0\n")
    names = ("study_path", "label")
    got = tables.read_csv(str(path), names=names)
    want = pd.read_csv(path, header=None, names=list(names))
    assert got["study_path"] == want["study_path"].tolist()
    assert got["label"] == want["label"].tolist()
    path.write_text("image_file,choice\na,Upper Arm\nb,\n")
    got, want = tables.read_csv(str(path)), pd.read_csv(path)
    assert str(got.lower("choice")) == str(want["choice"].str.lower()
                                          .tolist())
    path.write_text("n,choice\n1,a\n")
    with pytest.raises(AttributeError):
        pd.read_csv(path)["n"].str.lower()
    with pytest.raises(AttributeError):
        tables.read_csv(str(path)).lower("n")


def test_csv_writer_matches_to_csv(tmp_path):
    columns = ("path", "n", "x", "flag", "text")
    rows = [("a,b.png", 1, 0.1, True, 'say "hi"'),
            ("c.png", 2, float("nan"), False, "two\nlines"),
            ("d.png", 3, 1e16, True, ""),
            ("e.png", 4, np.float64(1e-5), False, "plain")]
    tables.write_csv(str(tmp_path / "p.csv"), columns, rows)
    pd.DataFrame(rows, columns=columns).to_csv(tmp_path / "j.csv",
                                               index=False)
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv") \
        .read_bytes()
    tables.write_csv(str(tmp_path / "e.csv"), (), [])
    assert (tmp_path / "e.csv").read_text() == \
        pd.DataFrame([]).to_csv(index=False)


def test_read_table_reads_the_csv_twin_and_raises_as_jax(tmp_path):
    pd.DataFrame({"a": [1, 2], "b": ["x", "y"]}).to_csv(tmp_path / "t.csv",
                                                        index=False)
    got = datasets.read_table(str(tmp_path / "t.xlsx"))
    assert got["a"] == [1, 2] and got["b"] == ["x", "y"]
    # a workbook (a zip holding xl/workbook.xml) without its twin: pandas
    # needs openpyxl for it, which is not installed
    with zipfile.ZipFile(tmp_path / "only.xlsx", "w") as zf:
        zf.writestr("xl/workbook.xml", "<workbook/>")
    for mod in (datasets, jds):
        with pytest.raises(RuntimeError, match="no CSV fallback"):
            mod.read_table(str(tmp_path / "only.xlsx"))
        with pytest.raises(FileNotFoundError):
            mod.read_table(str(tmp_path / "none.xlsx"))


# --------------------------------------------------------------------------
# fixture trees (tests/test_real_parsers.py's layouts, widened)
# --------------------------------------------------------------------------

def _make_internal(root, widened):
    os.makedirs(root / "initial_images", exist_ok=True)
    sites = ["Clavicula", "Manus", "Pes", "Femur", "Tibia", "Humerus"]
    rows = []
    for i in range(12):
        rows.append({
            "image": f"t{i}.png",
            "pat_nr": 100 + i // 2 if widened else f"P{i // 2}",
            "sex": "W" if i % 2 == 0 else "M",
            "age_initialdiagnosis": 20 + i,
            "anatomy_site": sites[i % len(sites)],
            "entity": "" if widened and i == 3 else "osteochondroma",
        })
    if widened == "gap":  # a missing patient number: the column is float
        rows[5]["pat_nr"] = None
    pd.DataFrame(rows).to_csv(root / "included_patients.csv", index=False)
    healthy = [{"file": str(root / "initial_images" / f"h{i}.png"),
                "patient_id": 900 + i // 2 if widened else f"H{i // 2}",
                "sex": "F" if i % 2 else "M", "age": 30 + i,
                "anatomy_site": "knee"} for i in range(8)]
    pd.DataFrame(healthy).to_csv(root / "healthy_subset_new_cleaned.csv",
                                 index=False)
    return root


def _make_btxrd(root):
    os.makedirs(root / "images", exist_ok=True)
    rows = []
    for i in range(12):
        row = {"image_id": f"b{i}.jpg", "tumor": i % 2,
               "gender": "F" if i % 2 else "M", "age": 15 + i}
        for site in jds._BTXRD_SITES:
            row[site] = 0
        for t in jds._BTXRD_TUMOR_TYPES:
            row[t] = 0
        if row["tumor"]:
            row[jds._BTXRD_SITES[i % 7]] = 1
            row[jds._BTXRD_TUMOR_TYPES[i % 5]] = 1
        rows.append(row)
    pd.DataFrame(rows).to_csv(root / "dataset.csv", index=False)
    pd.DataFrame([{"image_file": r["image_id"], "choice": "KNEE"}
                  for r in rows if r["tumor"] == 0]).to_csv(
        root / "BTXRD_healthy_anatomy_sites.csv", index=False)
    return root


def _make_mura(root):
    for split, patients, site in (("train", range(6), "WRIST"),
                                  ("valid", (90, 91), "ELBOW")):
        labels, images = [], []
        for p in patients:
            for s in (1, 2) if split == "train" else (1,):
                lbl = p % 2
                study = (f"MURA-v1.1/{split}/XR_{site}/patient{p:05d}/"
                         f"study{s}_{'positive' if lbl else 'negative'}/")
                labels.append({"study_path": study, "label": lbl})
                images += [study + f"image{k + 1}.png" for k in range(2)]
        pd.DataFrame(labels).to_csv(root / f"{split}_labeled_studies.csv",
                                    index=False, header=False)
        pd.DataFrame({"p": images}).to_csv(root / f"{split}_image_paths.csv",
                                           index=False, header=False)
    return root


def _make_lera(root, numeric_cases=False):
    labels = []
    for c in range(8):
        case = f"{1000 + c}" if numeric_cases else f"case{c:03d}"
        os.makedirs(root / case / "ST-1", exist_ok=True)
        for i in range(2):
            (root / case / "ST-1" / f"im{i}.png").touch()
        labels.append({"case_number": case,
                       "anatomy_site": ("XR HIP", "XR KNEE")[c % 2],
                       "label": c // 2 % 2})
    pd.DataFrame(labels).to_csv(root / "labels.csv", index=False)
    return root


def _same_samples(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert np.array_equal(a[k], b[k]), k
            elif isinstance(b[k], float):
                assert _same_cell(a[k], b[k]), (k, a[k], b[k])
            else:
                assert a[k] == b[k], (k, a[k], b[k])


def _frozen(samples, root, group_key, name, module):
    module.create_frozen_split(samples, str(root), stratify_keys=("tumor",),
                               group_key=group_key,
                               cache_dir=str(root / "dc"), dataset_name=name)


# --------------------------------------------------------------------------
# the readers against the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("widened", [False, True, "gap"],
                         ids=["strings", "numeric_ids", "missing_id"])
def test_internal_matches_jax(tmp_path, widened):
    root = _make_internal(tmp_path, widened)
    parsed = jds.InternalDataset.__new__(jds.InternalDataset)
    parsed.path, parsed.using_crops = str(root), False
    _frozen(parsed._parse(), root, "patient_number", "INTERNAL", jsplits)
    ours = datasets.InternalDataset(path=str(root), cache_dir=str(root / "dc"))
    theirs = jds.InternalDataset(path=str(root), cache_dir=str(root / "dc"))
    _same_samples(ours.train_val, theirs.train_val)
    _same_samples(ours.test, theirs.test)
    assert ours.cv_folds(n_splits=3) == [
        (list(tr), list(va)) for tr, va in theirs.cv_folds(n_splits=3)]
    entities = {s["entity"] for s in ours.train_val + ours.test}
    assert ("nan" in entities) == bool(widened)
    if widened == "gap":  # a float column: "100.0", and "nan" for the gap
        assert {"100.0", "nan"} <= {s["patient_number"]
                                    for s in ours.train_val + ours.test}


def test_btxrd_matches_jax(tmp_path):
    root = _make_btxrd(tmp_path)
    samples = [{"image_path": str(root / "images" / f"b{i}.jpg"),
                "tumor": i % 2} for i in range(12)]
    _frozen(samples, root, None, "BTXRD", jsplits)
    kw = dict(path=str(root), cache_dir=str(root / "dc"),
              healthy_sites_xlsx=str(root / "BTXRD_healthy_anatomy_sites"
                                            ".xlsx"))
    ours, theirs = datasets.BTXRDDataset(**kw), jds.BTXRDDataset(**kw)
    _same_samples(ours.train_val, theirs.train_val)
    _same_samples(ours.test, theirs.test)
    assert ours.cv_folds(n_splits=2) == [
        (list(tr), list(va)) for tr, va in theirs.cv_folds(n_splits=2)]
    assert {s["anatomy_site"] for s in ours.test + ours.train_val
            if s["tumor"] == 0} == {"knee"}


def test_mura_matches_jax_and_writes_then_checks_its_hash(tmp_path):
    (tmp_path / "MURA").mkdir()
    root = _make_mura(tmp_path / "MURA")
    ours = datasets.MURADataset(CaptionPool(), path=str(root),
                                cache_dir=str(tmp_path / "p"))
    theirs = jds.MURADataset(JPool(), path=str(root),
                             cache_dir=str(tmp_path / "j"))
    _same_samples(ours.train_val, theirs.train_val)
    _same_samples(ours.test, theirs.test)
    assert (tmp_path / "p" / "MURA_test_set_hash.txt").read_bytes() == \
        (tmp_path / "j" / "MURA_test_set_hash.txt").read_bytes()
    assert ours.cv_folds(n_splits=3) == [
        (list(tr), list(va)) for tr, va in theirs.cv_folds(n_splits=3)]
    # the second run checks the hash each package wrote
    datasets.MURADataset(CaptionPool(), path=str(root),
                         cache_dir=str(tmp_path / "j"))
    (tmp_path / "p" / "MURA_test_set_hash.txt").write_text("bad")
    with pytest.raises(RuntimeError, match="hash mismatch"):
        datasets.MURADataset(CaptionPool(), path=str(root),
                             cache_dir=str(tmp_path / "p"))


@pytest.mark.parametrize("numeric_cases", [False, True])
def test_lera_index_and_samples_match_jax(tmp_path, numeric_cases):
    """The first run parses the index it built, the second the index read
    back; numeric case names come through both as integers."""
    trees = {}
    for side in ("p", "j"):
        trees[side] = _make_lera(tmp_path / side, numeric_cases)
    reader = jds.LERADataset.__new__(jds.LERADataset)
    reader.path = str(trees["j"])
    rows = reader._build_index()
    samples = [{"image_path": str(r["image_path"]), "label": r["label"],
                "case_number": r["case_number"]} for _, r in rows.iterrows()]
    for side, module in (("p", splits), ("j", jsplits)):
        module.create_frozen_split(
            [dict(s, image_path=s["image_path"].replace(
                str(trees["j"]), str(trees[side]))) for s in samples],
            str(trees[side]), stratify_keys=("label",),
            group_key="case_number", cache_dir=str(trees[side] / "dc"),
            dataset_name="LERA")
    for side in ("p", "j"):
        assert (trees[side] / "test_set_split.csv").exists()
    assert (trees["p"] / "test_set_split.csv").read_text() == \
        (trees["j"] / "test_set_split.csv").read_text().replace(
            str(trees["j"]), str(trees["p"]))
    for run in range(2):
        ours = datasets.LERADataset(CaptionPool(), path=str(trees["p"]),
                                    cache_dir=str(trees["p"] / "dc"))
        theirs = jds.LERADataset(JPool(), path=str(trees["j"]),
                                 cache_dir=str(trees["j"] / "dc"))
        for a, b in ((ours.train_val, theirs.train_val),
                     (ours.test, theirs.test)):
            _same_samples([dict(s, image_path=s["image_path"].replace(
                str(trees["p"]), str(trees["j"]))) for s in a], b)
        assert ours.cv_folds(n_splits=2) == [
            (list(tr), list(va)) for tr, va in theirs.cv_folds(n_splits=2)]
        assert (trees["p"] / "dataset.csv").read_text() == \
            (trees["j"] / "dataset.csv").read_text().replace(
                str(trees["j"]), str(trees["p"]))
    assert all(s["anatomy_site"] in ("HIP", "KNEE") for s in ours.train_val)


# --------------------------------------------------------------------------
# the frozen split's files and errors
# --------------------------------------------------------------------------

def _split_samples(n=24):
    return [{"image_path": f"/d/img,{i}.png", "tumor": i % 2,
             "anatomy_site": ("knee", "hip")[i // 2 % 2],
             "patient_number": str(i // 3)} for i in range(n)]


@pytest.mark.parametrize("group_key", [None, "patient_number"])
def test_frozen_split_files_are_byte_equal(tmp_path, group_key):
    for side, module in (("p", splits), ("j", jsplits)):
        (tmp_path / side).mkdir()
        train, test = module.create_frozen_split(
            _split_samples(), str(tmp_path / side),
            stratify_keys=("tumor", "anatomy_site"), group_key=group_key,
            seed=5, cache_dir=str(tmp_path / side / "dc"),
            dataset_name="X")
        if side == "p":
            ours = (train, test)
        else:
            assert ours == (train, test)
    for name in ("test_set_split.csv", os.path.join("dc",
                                                     "X_test_set_hash.txt")):
        assert filecmp.cmp(tmp_path / "p" / name, tmp_path / "j" / name,
                           shallow=False), name
    # each package loads the other's split
    got = splits.load_frozen_split(_split_samples(), str(tmp_path / "j"),
                                   str(tmp_path / "j" / "dc"), "X")
    want = jsplits.load_frozen_split(_split_samples(), str(tmp_path / "p"),
                                     str(tmp_path / "p" / "dc"), "X")
    assert got == want == ours


def test_frozen_split_tamper_drift_and_missing_files_raise(tmp_path):
    splits.create_frozen_split(_split_samples(), str(tmp_path),
                               stratify_keys=("tumor",), group_key=None,
                               cache_dir=str(tmp_path / "dc"),
                               dataset_name="X")
    drifted = _split_samples() + [{"image_path": "/d/new.png", "tumor": 1}]
    for module in (splits, jsplits):
        with pytest.raises(KeyError, match="drifted"):
            module.load_frozen_split(drifted, str(tmp_path))
        with pytest.raises(FileNotFoundError, match="hash file"):
            module.load_frozen_split(_split_samples(), str(tmp_path),
                                     str(tmp_path / "dc"), "Y")
        with pytest.raises(FileNotFoundError, match="Frozen test split"):
            module.load_frozen_split(_split_samples(), str(tmp_path / "dc"))
    (tmp_path / "dc" / "X_test_set_hash.txt").write_text("bad")
    for module in (splits, jsplits):
        with pytest.raises(RuntimeError, match="hash mismatch"):
            module.load_frozen_split(_split_samples(), str(tmp_path),
                                     str(tmp_path / "dc"), "X")


# --------------------------------------------------------------------------
# the PNG reader against cv2
# --------------------------------------------------------------------------

def _filtered_png(path, img, filters, interlace=0, depth=8, colour=None):
    """A PNG of ``img`` with row y under filter ``filters[y % len]``."""
    h, w, c = img.shape
    bpp, stride = c, w * c
    rows = img.reshape(h, stride).astype(np.int32)
    out = []
    for y in range(h):
        f, cur = filters[y % len(filters)], rows[y]
        up = rows[y - 1] if y else np.zeros(stride, np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8)
                   .tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, depth,
                       colour if colour is not None
                       else {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, interlace)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chipchunk(b"IHDR", ihdr)
                 + chipchunk(b"IDAT", zlib.compress(b"".join(out)))
                 + chipchunk(b"IEND", b""))


chipchunk = chip_smoke_data._chunk


def _cv2_decode(path):
    return jph.decode_image(path)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_matches_cv2_on_images_cv2_wrote(tmp_path, channels):
    rng = np.random.default_rng(channels)
    for i, (h, w) in enumerate([(37, 53), (64, 40), (9, 130)]):
        smooth = np.add.outer(np.arange(h), 2 * np.arange(w))[..., None]
        img = ((smooth + rng.integers(0, 6, (h, w, channels))) % 256) \
            .astype(np.uint8)
        if i == 2:
            img = rng.integers(0, 256, (h, w, channels), np.uint8)
        path = str(tmp_path / f"{i}.png")
        assert cv2.imwrite(path, img[..., 0] if channels == 1 else img)
        assert np.array_equal(read_png(path), _cv2_decode(path))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_undoes_each_row_filter_as_cv2(tmp_path, channels):
    rng = np.random.default_rng(10 + channels)
    img = rng.integers(0, 256, (11, 17, channels), np.uint8)
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        path = str(tmp_path / f"f{''.join(map(str, filters))}.png")
        _filtered_png(path, img, filters)
        got = read_png(path)
        assert np.array_equal(got, _cv2_decode(path)), filters
        assert got.shape == (11, 17, 1 if channels == 1 else 3)
    # the corpus writer's PNGs (filter 0) too
    chip_smoke_data.write_png(tmp_path / "w.png", img)
    assert np.array_equal(read_png(str(tmp_path / "w.png")),
                          _cv2_decode(str(tmp_path / "w.png")))


def test_png_reader_refuses_what_it_cannot_read(tmp_path, monkeypatch):
    img = np.random.default_rng(3).integers(0, 256, (8, 8, 3), np.uint8)
    cases = {}
    cv2.imwrite(str(tmp_path / "deep.png"), img.astype(np.uint16) * 257)
    cases["deep.png"] = "16-bit"
    _filtered_png(str(tmp_path / "lace.png"), img, [0], interlace=1)
    cases["lace.png"] = "interlacing"
    _filtered_png(str(tmp_path / "pal.png"), img[..., :1], [0], colour=3)
    cases["pal.png"] = "colour type 3"
    cv2.imwrite(str(tmp_path / "x.jpg"), img)
    cases["x.jpg"] = "not a PNG"
    for name, what in cases.items():
        with pytest.raises(PNGError, match=f"{what}.*cv2.*PIL"):
            read_png(str(tmp_path / name))
    # decode_image takes this route where neither cv2 nor PIL is installed
    monkeypatch.setattr(preprocess_host, "_cv2", lambda: None)
    monkeypatch.setattr(preprocess_host, "_pil_image", lambda: None)
    assert preprocess_host.decoder() == "png (numpy + zlib)"
    cv2.imwrite(str(tmp_path / "ok.png"), img)
    assert np.array_equal(preprocess_host.decode_image(str(tmp_path /
                                                           "ok.png")),
                          _cv2_decode(str(tmp_path / "ok.png")))
    with pytest.raises(PNGError, match="cv2.*PIL"):
        preprocess_host.decode_image(str(tmp_path / "x.jpg"))


# --------------------------------------------------------------------------
# ImageCache.build against the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_image_cache_build_matches_jax_and_each_opens_the_others(
        tmp_path, native):
    rng = np.random.default_rng(4)
    paths = []
    for i in range(6):
        paths.append(str(tmp_path / f"{i}.png"))
        chip_smoke_data.write_png(paths[-1], chip_smoke_data.radiograph(
            rng, int(rng.integers(20, 60)), int(rng.integers(20, 60)),
            (1, 3, 4)[i % 3]))
    kw = dict(image_size=32, crop=True, maximum_crop_ratio=0.05)
    ours = preprocess_host.ImageCache.build(
        paths, str(tmp_path / "p"), use_native=native, num_workers=2, **kw)
    theirs = jph.ImageCache.build(paths, str(tmp_path / "j"),
                                  use_native=native, **kw)
    assert sorted(os.listdir(tmp_path / "p")) == \
        sorted(os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "j"):
        assert filecmp.cmp(tmp_path / "p" / name, tmp_path / "j" / name,
                           shallow=False), name
    assert ours.options_key == theirs.options_key
    assert np.array_equal(np.asarray(ours.data), np.asarray(theirs.data))
    # each package takes the other's cache as a hit
    shutil.rmtree(tmp_path / "p")
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    hit = preprocess_host.ImageCache.build(paths, str(tmp_path / "j"),
                                           use_native=native, **kw)
    assert os.path.samefile(hit.data.filename, theirs.data.filename)
    jhit = jph.ImageCache.build(paths, str(tmp_path / "p"),
                                use_native=native, **kw)
    assert np.array_equal(np.asarray(jhit.data), np.asarray(ours.data))
    assert preprocess_host.ImageCache.open(
        paths, str(tmp_path / "j"), native=native, **kw).gather([4, 1]) \
        .tolist() == theirs.gather([4, 1]).tolist()
