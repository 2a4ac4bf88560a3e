"""The port's caption generator (``vlp_tpu_torch/data/caption_generator.py``)
against the JAX package's template path on the CPU: the rows, the CSV's
bytes (the repository's ``res/data/pretrain/captions.csv`` among them),
``fill_missing`` on thinned pools and its rewritten file, and the command
line. Exact everywhere.
"""
import filecmp
import os
import shutil
import subprocess
import sys

import pandas as pd
import pytest

from vlp_tpu.data import caption_generator as jgen
from vlp_tpu_torch.data import caption_generator as gen
from vlp_tpu_torch.data.captions import DEFAULT_CAPTIONS_CSV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("per,sites", [(40, None), (7, None), (64, None),
                                       (1, ["KNEE", "ELBOW"]), (0, None)])
def test_rows_match_the_jax_generator(per, sites):
    assert gen.generate_captions(per, sites) == \
        jgen.generate_captions(per, sites).to_dict("records")


def test_csv_is_byte_equal_to_the_jax_one_and_the_repositorys(tmp_path):
    ours = gen.main(str(tmp_path / "p" / "captions.csv"))
    theirs = jgen.main(str(tmp_path / "j" / "captions.csv"))
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert filecmp.cmp(ours, DEFAULT_CAPTIONS_CSV, shallow=False)
    gen.main(str(tmp_path / "p" / "ten.csv"), 10)
    jgen.main(str(tmp_path / "j" / "ten.csv"), 10)
    assert filecmp.cmp(tmp_path / "p" / "ten.csv", tmp_path / "j" / "ten.csv",
                       shallow=False)


def _thinned(path, keep):
    df = pd.read_csv(DEFAULT_CAPTIONS_CSV)
    keep(df).to_csv(path, index=False)


@pytest.mark.parametrize("case", ["missing_pair", "half", "extra_column",
                                  "duplicates", "complete"])
def test_fill_missing_matches_the_jax_one(tmp_path, case):
    keeps = {
        "missing_pair": lambda df: df[~((df.anatomy_site == "HIP")
                                        & (df.abnormality_label == 1))],
        "half": lambda df: df.iloc[::2],
        "extra_column": lambda df: df.iloc[::3].assign(source="llm"),
        "duplicates": lambda df: pd.concat([df.iloc[:30], df.iloc[:30]]),
        "complete": lambda df: df,
    }
    _thinned(tmp_path / "p.csv", keeps[case])
    shutil.copy(tmp_path / "p.csv", tmp_path / "j.csv")
    added = gen.fill_missing(str(tmp_path / "p.csv"))
    assert added == jgen.fill_missing(str(tmp_path / "j.csv"))
    assert (added == 0) == (case == "complete")
    assert filecmp.cmp(tmp_path / "p.csv", tmp_path / "j.csv", shallow=False)
    assert gen.fill_missing(str(tmp_path / "p.csv")) == 0


def test_command_line_writes_the_same_file(tmp_path):
    out = tmp_path / "cli" / "captions.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "vlp_tpu_torch.data.caption_generator",
         str(out)], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO), check=True)
    assert proc.stdout.strip() == f"wrote {out}"
    assert filecmp.cmp(out, DEFAULT_CAPTIONS_CSV, shallow=False)
