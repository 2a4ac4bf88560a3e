"""Cross-validation splits (the port's copy of the numpy parts of
``vlp_tpu/data/splits.py``).

The reference splits with scikit-learn, grouped by patient where patient
ids exist (INTERNAL/MURA/LERA: ``StratifiedGroupKFold``) and ungrouped for
BTXRD (``StratifiedKFold``), both with ``shuffle=True,
random_state=seed`` (INTERNALDataset.py:242-273, BTXRDDataset.py:208-235).
The machine with the card has no scikit-learn, so ``cv_splits`` runs both
algorithms here in numpy: the same draws from one
``np.random.RandomState(seed)`` in the same order, the same ``ValueError``
when every class is thinner than ``n_splits`` (or there are fewer samples or
groups than folds) and the same ``UserWarning`` when only some are, hence
the same folds (``tests/test_torch_port_data.py`` holds them against the
JAX package on many seeds and sizes). The frozen test split of the real
datasets (``save_test_set_info``, ``save_test_set_hash``,
``check_test_set_hash``, ``load_frozen_split``, ``create_frozen_split``;
reference src/data/helpers/ensure_same_test_set.py) reads and writes the
JAX package's files with ``data/tables.py``: ``test_set_split.csv``
(pandas' bytes) beside the dataset and ``<DS>_test_set_hash.txt`` in the
cache directory, with the same errors.
"""
from __future__ import annotations

import hashlib
import os
import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vlp_tpu_torch.data.tables import read_csv, write_csv

Sample = Dict[str, object]


def hash_list_of_strings(strings: Sequence[str]) -> str:
    """sha256 over the sorted, concatenated strings (reference
    src/data/helpers/hash_list_of_dicts.py:5-10). Used for both test-set
    hashes and preprocessing-cache keys."""
    h = hashlib.sha256()
    for s in sorted(strings):
        h.update(str(s).encode("utf-8"))
    return h.hexdigest()


# --------------------------------------------------------------------------
# Frozen test split
# --------------------------------------------------------------------------

TEST_SPLIT_FILENAME = "test_set_split.csv"


def save_test_set_info(samples: Sequence[Sample], test_paths: Sequence[str],
                       dataset_dir: str) -> str:
    """Write the path -> in-test-set membership CSV into the dataset
    folder."""
    test_set = set(test_paths)
    out = os.path.join(dataset_dir, TEST_SPLIT_FILENAME)
    write_csv(out, ("image_path", "is_test"),
              [(s["image_path"], s["image_path"] in test_set)
               for s in samples])
    return out


def save_test_set_hash(test_paths: Sequence[str], cache_dir: str,
                       dataset_name: str) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    out = os.path.join(cache_dir, f"{dataset_name}_test_set_hash.txt")
    with open(out, "w") as fh:
        fh.write(hash_list_of_strings(list(test_paths)))
    return out


def check_test_set_hash(test_paths: Sequence[str], cache_dir: str,
                        dataset_name: str) -> None:
    """Raise if the frozen test split drifted from the recorded hash."""
    path = os.path.join(cache_dir, f"{dataset_name}_test_set_hash.txt")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Test-set hash file {path} is missing; refusing to proceed "
            "without split-integrity verification.")
    with open(path) as fh:
        expected = fh.read().strip()
    actual = hash_list_of_strings(list(test_paths))
    if actual != expected:
        raise RuntimeError(
            f"Test-set hash mismatch for {dataset_name}: the frozen test "
            f"split drifted (expected {expected[:12]}..., got "
            f"{actual[:12]}...).")


def load_frozen_split(samples: Sequence[Sample], dataset_dir: str,
                      cache_dir: Optional[str] = None,
                      dataset_name: Optional[str] = None
                      ) -> Tuple[List[Sample], List[Sample]]:
    """Split samples into (train, test) by membership in the frozen
    ``test_set_split.csv``; raises if the file is absent (the reference's
    FileNotFoundError tripwire, INTERNALDataset.py:211-213)."""
    split_path = os.path.join(dataset_dir, TEST_SPLIT_FILENAME)
    if not os.path.exists(split_path):
        raise FileNotFoundError(
            f"Frozen test split {split_path} not found. Create it once with "
            "create_frozen_split() and commit it with the dataset.")
    table = read_csv(split_path)
    is_test = {str(p): bool(t)
               for p, t in zip(table["image_path"], table["is_test"])}
    train, test = [], []
    for s in samples:
        key = str(s["image_path"])
        if key not in is_test:
            raise KeyError(
                f"Sample {key} missing from frozen split {split_path}; "
                "the dataset drifted relative to the frozen split.")
        (test if is_test[key] else train).append(s)
    if cache_dir is not None and dataset_name is not None:
        check_test_set_hash([s["image_path"] for s in test], cache_dir,
                            dataset_name)
    return train, test


def create_frozen_split(samples: Sequence[Sample], dataset_dir: str, *,
                        stratify_keys: Sequence[str],
                        group_key: Optional[str] = None,
                        test_size: float = 0.2, seed: int = 17,
                        cache_dir: Optional[str] = None,
                        dataset_name: Optional[str] = None
                        ) -> Tuple[List[Sample], List[Sample]]:
    """One-time creation of the frozen test split: the first fold of a
    grouped (``group_key``) or plain stratified k-fold with
    k = round(1 / test_size) is the test set (reference
    INTERNALDataset.py:221-240, BTXRDDataset.py:189-197)."""
    samples = list(samples)
    y = _stratify_labels(samples, stratify_keys)
    n_splits = max(2, round(1.0 / test_size))
    if group_key is not None:
        groups = np.array([str(s[group_key]) for s in samples])
        train_idx, test_idx = stratified_group_kfold(y, groups, n_splits,
                                                     seed)[0]
    else:
        train_idx, test_idx = stratified_kfold(y, n_splits, seed)[0]
    test_paths = [samples[i]["image_path"] for i in test_idx]
    save_test_set_info(samples, test_paths, dataset_dir)
    if cache_dir is not None and dataset_name is not None:
        save_test_set_hash(test_paths, cache_dir, dataset_name)
    return [samples[i] for i in train_idx], [samples[i] for i in test_idx]


def _stratify_labels(samples: Sequence[Sample], keys: Sequence[str]) -> np.ndarray:
    return np.array(
        ["|".join(str(s.get(k, "undefined")) for k in keys) for s in samples])


# Joint CV stratification keys, matching the reference label strings:
# INTERNAL f"{tumor}, {anatomy_site}" (INTERNALDataset.py:259), MURA/LERA
# f"{label}, {anatomy_site}" (MURADataset.py:272, LERADataset.py:255). The
# separator differs ('|' vs ', ') but stratification only depends on the
# label PARTITION, which is identical.
DOWNSTREAM_STRATIFY = ("tumor", "anatomy_site")
PRETRAIN_STRATIFY = ("label", "anatomy_site")


def btxrd_stratify_label(s: Sample) -> str:
    """BTXRD stratifies healthy samples as site 'undefined' so the val split
    matches the pre-site-annotation splits (BTXRDDataset.py:227-229)."""
    site = s["anatomy_site"] if int(s["tumor"]) == 1 else "undefined"
    return f"{s['tumor']}|{site}"


# --------------------------------------------------------------------------
# scikit-learn's two splitters, in numpy
# --------------------------------------------------------------------------

def _check_sizes(n_splits: int, n_samples: int) -> None:
    if n_splits > n_samples:
        raise ValueError(
            f"Cannot have number of splits n_splits={n_splits} greater than "
            f"the number of samples: n_samples={n_samples}.")


def _check_classes(n_splits: int, counts: np.ndarray) -> None:
    if np.all(n_splits > counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         "number of members in each class.")
    if n_splits > counts.min():
        warnings.warn(f"The least populated class in y has only "
                      f"{counts.min()} members, which is less than "
                      f"n_splits={n_splits}.", UserWarning)


def _folds_from_masks(masks: List[np.ndarray]):
    indices = np.arange(len(masks[0]))
    return [(indices[~m], indices[m]) for m in masks]


def stratified_kfold(y: np.ndarray, n_splits: int, seed: int):
    """``StratifiedKFold(n_splits, shuffle=True, random_state=seed)
    .split(X, y)``: each class's sorted positions dealt round-robin over the
    folds, then each class's fold labels shuffled."""
    y = np.asarray(y)
    _check_sizes(n_splits, len(y))
    rng = np.random.RandomState(seed)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    # classes numbered by first appearance
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    _check_classes(n_splits, np.bincount(y_encoded))
    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    return _folds_from_masks([test_folds == i for i in range(n_splits)])


def _best_fold(y_counts_per_fold: np.ndarray, y_cnt: np.ndarray,
               group_y_counts: np.ndarray) -> int:
    """The fold whose per-class spread (mean over classes of the std over
    folds of each class's share) is least with the group added; ties (to
    ``np.isclose``) go to the fold holding fewer samples, then the lower
    index."""
    best_fold, min_eval, min_samples = None, np.inf, np.inf
    for i in range(len(y_counts_per_fold)):
        y_counts_per_fold[i] += group_y_counts
        std_per_class = np.std(y_counts_per_fold / y_cnt.reshape(1, -1),
                               axis=0)
        y_counts_per_fold[i] -= group_y_counts
        fold_eval = np.mean(std_per_class)
        samples_in_fold = np.sum(y_counts_per_fold[i])
        if fold_eval < min_eval or (np.isclose(fold_eval, min_eval)
                                    and samples_in_fold < min_samples):
            min_eval, min_samples, best_fold = fold_eval, samples_in_fold, i
    return best_fold


def stratified_group_kfold(y: np.ndarray, groups: np.ndarray, n_splits: int,
                           seed: int):
    """``StratifiedGroupKFold(n_splits, shuffle=True, random_state=seed)
    .split(X, y, groups)``: the groups shuffled, sorted (stably) by the std
    of their class counts, largest first, and each assigned greedily to the
    fold that keeps the class shares most even."""
    y = np.asarray(y)
    _check_sizes(n_splits, len(y))
    rng = np.random.RandomState(seed)
    _, y_inv, y_cnt = np.unique(y, return_inverse=True, return_counts=True)
    _check_classes(n_splits, y_cnt)
    n_classes = len(y_cnt)
    _, groups_inv, groups_cnt = np.unique(groups, return_inverse=True,
                                          return_counts=True)
    n_groups = len(groups_cnt)
    if n_splits > n_groups:
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} "
                         f"greater than the number of groups: {n_groups}.")
    y_counts_per_group = np.zeros((n_groups, n_classes))
    for class_idx, group_idx in zip(y_inv, groups_inv):
        y_counts_per_group[group_idx, class_idx] += 1
    y_counts_per_fold = np.zeros((n_splits, n_classes))
    groups_per_fold = defaultdict(set)
    perm = np.arange(n_groups)
    rng.shuffle(perm)
    y_counts_per_group = y_counts_per_group[perm]
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.size)
    groups_inv = inv_perm[groups_inv]
    order = np.argsort(-np.std(y_counts_per_group, axis=1), kind="stable")
    for group_idx in order:
        group_y_counts = y_counts_per_group[group_idx]
        fold = _best_fold(y_counts_per_fold, y_cnt, group_y_counts)
        y_counts_per_fold[fold] += group_y_counts
        groups_per_fold[fold].add(group_idx)
    masks = []
    for i in range(n_splits):
        mask = np.zeros(len(y), dtype=bool)
        mask[[j for j, g in enumerate(groups_inv)
              if g in groups_per_fold[i]]] = True
        masks.append(mask)
    return _folds_from_masks(masks)


# --------------------------------------------------------------------------
# Cross-validation splits
# --------------------------------------------------------------------------

def cv_splits(
    samples: Sequence[Sample],
    *,
    n_splits: int,
    stratify_keys: Optional[Sequence[str]] = None,
    stratify_fn=None,
    group_key: Optional[str] = None,
    seed: int = 42,
) -> List[Tuple[List[int], List[int]]]:
    """(train_idx, val_idx) per fold. Grouped variant prevents patient
    leakage (reference INTERNALDataset.py:242-273 / MURADataset.py:261-289
    group by patient; BTXRD uses plain StratifiedKFold). ``stratify_fn``
    overrides key-joining for per-sample label rules (BTXRD healthy sites)."""
    samples = list(samples)
    if stratify_fn is not None:
        y = np.array([str(stratify_fn(s)) for s in samples])
    else:
        y = _stratify_labels(samples, stratify_keys)

    def run(labels):
        if group_key is not None:
            groups = np.array([str(s[group_key]) for s in samples])
            return stratified_group_kfold(labels, groups, n_splits, seed)
        return stratified_kfold(labels, n_splits, seed)

    try:
        splits = run(y)
    except ValueError:
        # Joint (label, site) classes can be thinner than n_splits on tiny
        # fixtures/subsampled runs, where the reference's sklearn call
        # would crash outright. Degrade to the primary key (the part before
        # the first '|') and say so.
        primary = np.array([label.split("|", 1)[0] for label in y])
        if len(set(primary)) == len(set(y)):
            raise
        warnings.warn(
            f"joint stratification infeasible for n_splits={n_splits} "
            "(a class has fewer members than folds); falling back to the "
            "primary label only", stacklevel=2)
        splits = run(primary)
    return [([int(i) for i in tr], [int(i) for i in va]) for tr, va in splits]


def assert_no_group_leakage(
    train: Sequence[Sample], other: Sequence[Sample], group_key: str
) -> None:
    """Patient-leakage tripwire (reference INTERNALDataset.py:77-82)."""
    g_train = {str(s[group_key]) for s in train}
    g_other = {str(s[group_key]) for s in other}
    overlap = g_train & g_other
    if overlap:
        raise AssertionError(
            f"Group leakage across splits for {group_key!r}: "
            f"{sorted(overlap)[:5]}{'...' if len(overlap) > 5 else ''}")


def class_weights(labels: Sequence[int], num_classes: int = 2) -> Tuple[float, ...]:
    """w_c = N / (num_classes * N_c) (reference DownstreamDataModule.py:328-332)."""
    labels = np.asarray(labels)
    n = len(labels)
    weights = []
    for c in range(num_classes):
        n_c = int((labels == c).sum())
        weights.append(n / (num_classes * n_c) if n_c > 0 else 0.0)
    return tuple(weights)
