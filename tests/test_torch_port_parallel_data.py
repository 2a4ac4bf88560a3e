"""The port's data-parallel loaders, refusals and training entry point at 2
and 4 gloo ranks on the CPU (``torch_parallel_workers.run_ranks``), held
against one process of the port itself; and one NCCL step on two cards
(``gpu``, skipped below two).

- ``DeviceLoader`` on a mesh: every rank's batches are its rows ``[r b,
  (r + 1) b)`` of the one-process loader's global batches, bit for bit, in
  the host mode and the ``replicated`` and ``sharded`` resident modes
  (the corpus's 51 rows divide by neither 2 nor 4);
- ``NoDuplicateCaptionSampler``: captions unique within each main-phase
  global batch, every sample once an epoch (``tests/test_parallel.py:
  280-302``);
- the refusals: a batch that does not divide by the world (the JAX
  message), a ``data_parallel`` x ``model_parallel`` that is not the world
  (naming ROADMAP Queue 1 item 14), a ``model_parallel`` that does not
  divide it, the JAX driver's three refusals in its words (tp without the
  model axis, fsdp with it, ``shard_map`` with it), and a process group
  that does not form;
- ``python -m torch.distributed.run --nproc_per_node=2 -m
  vlp_tpu_torch.train --device cpu``: its fold metrics equal the
  one-process run's (the counts exactly, the rest within 1e-5 of the
  value: the global sums are added in another order), and only rank 0
  wrote files.
"""
import json
import multiprocessing as mp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parallel_workers import (loader_batches, loaders_worker,
                                    lonely_rank, refusals_worker, run_ranks,
                                    run_steps, steps_worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
N, GLOBAL_B = 51, 8
NBYTES = N * 8 * 8  # the bundle's uint8 8 x 8 corpus
MODES = {"host": 0.0, "replicated": 1.0,
         # a 1/N share fits, the whole corpus does not
         "sharded": 0.75 * NBYTES / 1e6}


@pytest.fixture(scope="module")
def loader_ranks(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cases = {mode: (N, GLOBAL_B, limit) for mode, limit in
                     MODES.items()}
            cache[world] = run_ranks(loaders_worker, world,
                                     tmp_path_factory.mktemp("loaders"),
                                     cases)
        return cache[world]

    return get


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_each_rank_gets_its_rows_of_the_global_batch(loader_ranks, world,
                                                     mode):
    ranks = loader_ranks(world)
    want_mode, want = loader_batches(None, N, GLOBAL_B, MODES[mode])
    # one process holds the whole corpus or none of it
    assert want_mode == ("local" if mode == "replicated" else None)
    b = GLOBAL_B // world
    for r, out in enumerate(ranks):
        got_mode, got = out[mode]
        assert got_mode == (None if mode == "host" else mode)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in ("image_u8", "label", "dataset_id", "input_ids",
                        "attention_mask", "caption_id", "mask"):
                np.testing.assert_array_equal(g[key],
                                              w[key][r * b:(r + 1) * b])
            np.testing.assert_array_equal(g["global_caption_id"],
                                          w["caption_id"])
            np.testing.assert_array_equal(g["global_mask"], w["mask"])


@pytest.mark.parametrize("world", WORLDS)
def test_global_batches_are_caption_unique_and_cover_the_epoch(
        loader_ranks, world):
    _, batches = loader_ranks(world)[0]["replicated"]
    counts = {c: 2 for c in range(N // 2)}
    counts[N // 2] = 1  # 51 rows: the last caption once
    per_epoch = len(batches) // 2
    assert per_epoch == -(-N // GLOBAL_B)
    for epoch in range(2):
        remaining = dict(counts)
        seen = 0
        for batch in batches[epoch * per_epoch:(epoch + 1) * per_epoch]:
            valid = batch["global_caption_id"][batch["global_mask"] > 0]
            if sum(1 for v in remaining.values() if v > 0) >= GLOBAL_B:
                assert len(set(valid.tolist())) == len(valid)
            for c in valid.tolist():
                remaining[c] -= 1
            seen += len(valid)
        assert seen == N
        assert all(v == 0 for v in remaining.values())


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_name_the_roadmap_item(world, tmp_path):
    (msgs, *_) = run_ranks(refusals_worker, world, tmp_path)
    assert msgs["batch"] == (
        f"batch_size=5 must be divisible by the {world}-shard data axis "
        "(every data shard gets an equal slice; adjust data.batch_size/"
        "eval_batch_size or mesh.data_parallel)")
    # fsdp and the 2-D mesh run (tests/test_torch_port_fsdp.py,
    # tests/test_torch_port_tp.py, M replicas under replicated); the JAX
    # driver's three refusals raise in its words, and a mesh that does not
    # tile the world raises naming the data axis's item
    w = world
    assert set(msgs) == {"batch", f"data_parallel={w + 1}",
                         "model_parallel=3", "param_sharding=tp",
                         "param_sharding=fsdp,model_parallel=2",
                         f"param_sharding=tp,model_parallel=2,"
                         f"data_parallel={w}",
                         "infonce_impl=shard_map,model_parallel=2"}
    for key in (f"data_parallel={w + 1}",
                f"param_sharding=tp,model_parallel=2,data_parallel={w}"):
        assert "ROADMAP.md Queue 1 item 14" in msgs[key], key
    assert msgs["model_parallel=3"].startswith(
        f"mesh.model_parallel=3 does not divide the {w} rank(s) launched")
    assert msgs["param_sharding=tp"].startswith(
        "mesh.param_sharding='tp' shards weights over the model axis — set "
        "mesh.model_parallel>1 (2-D data x model mesh).")
    assert msgs["param_sharding=fsdp,model_parallel=2"].startswith(
        "mesh.param_sharding='fsdp' shards over the data axis and never "
        "uses the model axis")
    assert msgs["infonce_impl=shard_map,model_parallel=2"].startswith(
        "mesh.infonce_impl='shard_map' is written for a 1-D data mesh; "
        "with mesh.model_parallel>1 use infonce_impl='gspmd'")


def test_a_group_that_does_not_form_raises(tmp_path):
    out = str(tmp_path / "msg")
    p = mp.get_context("spawn").Process(
        target=lonely_rank, args=(str(tmp_path / "store"), out))
    p.start()
    p.join(60)
    if p.is_alive():
        p.kill()
        p.join()
        pytest.fail("create_mesh hung without its peer")
    with open(out) as fh:
        msg = fh.read()
    assert "did not form" in msg and "rather than train alone" in msg


CLI = ["experiment=baseline_only_imaging_resnet34",
       "model.model=resnet_micro", "data.name=synthetic_downstream",
       "data.image_size=32", "data.batch_size=32", "data.eval_batch_size=8",
       "data.synthetic_num_samples=40", "data.disable_augmentations=true",
       "trainer.precision=fp32", "trainer.scan_steps=1",
       "trainer.max_epochs=1", "trainer.async_checkpointing=false"]
COUNTS = ("accuracy", "precision", "recall", "f1", "balanced_accuracy",
          "auroc")


def _run(cmd, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, timeout=400,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if "datacache" not in d)


def test_two_rank_cli_matches_one_process(tmp_path):
    one, two = tmp_path / "one", tmp_path / "two"
    _run([sys.executable, "-m", "vlp_tpu_torch.train", "--device", "cpu",
          *CLI, f"output_dir={one}"], tmp_path)
    _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
          "--nproc_per_node=2", "-m", "vlp_tpu_torch.train", "--device",
          "cpu", *CLI, f"output_dir={two}"], tmp_path)
    with open(one / "cv_summary.json") as fh:
        want = json.load(fh)
    with open(two / "cv_summary.json") as fh:
        got = json.load(fh)
    def kept(summary):  # wall-clock figures differ by nature
        return {k for k in summary
                if "time/" not in k and "images_per_sec" not in k}

    keys = kept(want)
    assert kept(got) == keys
    assert want["num_folds"] == 4
    for k in keys:
        # "<monitor>_best_<metric>_mean": the metric's last path element
        metric = k.split("_best_")[-1].rsplit("_", 1)[0].split("/")[-1]
        if metric in COUNTS or k == "num_folds":
            assert got[k] == want[k], k
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
    # rank 0 alone writes: the same files, each once
    assert _files(two) == _files(one)
    assert sum(1 for f in _files(two) if f.startswith("fold")) == 4


@pytest.mark.gpu
@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two CUDA devices")
def test_nccl_step_on_two_cards_matches_one_card(tmp_path):
    rng = np.random.default_rng(0)
    b, size = 8, 32
    spec = {"experiment": "baseline_only_imaging_resnet34",
            "overrides": ["model.model=resnet_micro",
                          f"data.image_size={size}"],
            "mean": 128.0, "std": 30.0, "spe": 10, "weights": None,
            "augment": True, "steps": 2, "device": "cuda",
            "batch": {"image_u8": rng.integers(0, 256, (b, size, size),
                                               dtype=np.uint8),
                      "label": rng.integers(0, 2, b).astype(np.int32),
                      "mask": np.ones(b, np.float32),
                      "dataset_id": (np.arange(b) % 2).astype(np.int32)}}
    ranks = run_ranks(steps_worker, 2, tmp_path, {"s": spec},
                      device="cuda")
    one = run_steps(spec, None)
    assert ranks[0]["s"]["losses"] == ranks[1]["s"]["losses"]
    assert ranks[0]["s"]["losses"][0] == pytest.approx(one["losses"][0],
                                                       rel=1e-3)
    for k, v in ranks[0]["s"]["state"].items():
        np.testing.assert_array_equal(ranks[1]["s"]["state"][k], v)
