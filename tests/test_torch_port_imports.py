"""The port's import boundary and its kernel loader.

The machine with the card need not have JAX, pandas, scikit-learn, cv2, PIL
or matplotlib (and the port must not need PyYAML), so the serving entry
point, the training step, the sweep, the evaluation tools and
chip_smoke.py must import without them (matplotlib is imported only where
a figure is drawn) and without
any module of the JAX package ``vlp_tpu``; and a missing CUDA compiler must
raise, never hand back a plain fallback.
"""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "orbax", "pandas", "sklearn", "cv2",
             "yaml", "PIL", "matplotlib")
# the pretrained-weight imports read the HF files and xrv's checkpoint
# themselves: the machine with the card has none of these packages
HF_PACKAGES = ("transformers", "huggingface_hub", "safetensors",
               "tokenizers", "torchxrayvision")
IMPORTS_JAX = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b",
                         re.MULTILINE)
# `import vlp_tpu`, `import vlp_tpu.x`, `from vlp_tpu(.x) import ...` at any
# indentation (lazy imports too), but not vlp_tpu_torch
IMPORTS_VLP_TPU = re.compile(r"^\s*(import|from)\s+vlp_tpu(?![\w])",
                             re.MULTILINE)
IMPORTS_HOST = re.compile(r"^\s*(import|from)\s+(yaml|sklearn)\b",
                          re.MULTILINE)
SWEEP = os.path.join(REPO, "configs", "sweeps", "pretrain", "vlp.yaml")


def test_serve_and_chip_smoke_import_without_jax_or_host_pipeline():
    code = ("import sys; import vlp_tpu_torch.serve, "
            "vlp_tpu_torch.train.step, vlp_tpu_torch.models.resnet, "
            "vlp_tpu_torch.models.bert, vlp_tpu_torch.models.vlm, "
            "vlp_tpu_torch.data.tokenize, "
            "vlp_tpu_torch.probes.conv_probe, "
            "vlp_tpu_torch.probes.bn_gemm_probe, "
            "vlp_tpu_torch.probes.mega_probe, "
            "vlp_tpu_torch.probes.mlp_probe, "
            "vlp_tpu_torch.probes.attn_probe, "
            "vlp_tpu_torch.config.core, vlp_tpu_torch.config.experiments, "
            "vlp_tpu_torch.data.captions, vlp_tpu_torch.data.datamodule, "
            "vlp_tpu_torch.data.encoding, vlp_tpu_torch.data.pipeline, "
            "vlp_tpu_torch.data.sampler, vlp_tpu_torch.data.splits, "
            "vlp_tpu_torch.data.synthetic, vlp_tpu_torch.data.taxonomy, "
            "vlp_tpu_torch.ops.metrics, vlp_tpu_torch.ops.retrieval, "
            "vlp_tpu_torch.utils.checkpoint, vlp_tpu_torch.utils.hparams, "
            "vlp_tpu_torch.utils.logging, vlp_tpu_torch.utils.profiling, "
            "vlp_tpu_torch.train.callbacks, vlp_tpu_torch.train.loop, "
            "vlp_tpu_torch.train.driver, vlp_tpu_torch.parallel.mesh, "
            "vlp_tpu_torch.parallel.collectives, "
            "vlp_tpu_torch.parallel.infonce, vlp_tpu_torch.parallel.fsdp, "
            "vlp_tpu_torch.parallel.tp, vlp_tpu_torch.parallel.pipeline, "
            "vlp_tpu_torch.parallel.sequence, vlp_tpu_torch.utils.flops, "
            "vlp_tpu_torch.utils.yaml_subset, vlp_tpu_torch.train.sweep, "
            "vlp_tpu_torch.setup_check, vlp_tpu_torch.data.tables, "
            "vlp_tpu_torch.data.datasets, vlp_tpu_torch.data.png, "
            "vlp_tpu_torch.data.preprocess_host, "
            "vlp_tpu_torch.data.caption_generator, vlp_tpu_torch.native, "
            "vlp_tpu_torch.eval.plotting, vlp_tpu_torch.eval.replot, "
            "vlp_tpu_torch.eval.linear_probe_eval, "
            "vlp_tpu_torch.eval.results_table, vlp_tpu_torch.eval.latex, "
            "vlp_tpu_torch.eval.eda, vlp_tpu_torch.data.dicom_tools, "
            "vlp_tpu_torch.data.base, vlp_tpu_torch.utils.hf_files, "
            "vlp_tpu_torch.models.torch_import, "
            "chip_smoke, chip_smoke_tp, chip_smoke_pp, chip_smoke_data, "
            "chip_smoke_eval, chip_smoke_weights; "
            f"print([m for m in {FORBIDDEN + HF_PACKAGES!r} "
            "if m in sys.modules] + "
            "[m for m in sys.modules if m.split('.')[0] == 'vlp_tpu'])")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def _port_sources():
    paths = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                             "chip_smoke_tp.py",
                                             "chip_smoke_pp.py",
                                             "chip_smoke_data.py",
                                             "chip_smoke_eval.py",
                                             "chip_smoke_weights.py",
                                             "scripts/trace_pipeline.py")]
    for root, _, files in os.walk(os.path.join(REPO, "vlp_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def test_port_sources_cover_the_parallel_package():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {os.path.join("vlp_tpu_torch", "parallel", f) for f in (
        "__init__.py", "mesh.py", "collectives.py", "infonce.py",
        "fsdp.py", "tp.py", "pipeline.py", "sequence.py")} <= names
    assert {os.path.join("vlp_tpu_torch", *f) for f in (
        ("utils", "flops.py"), ("utils", "yaml_subset.py"),
        ("train", "sweep.py"), ("setup_check.py",))} <= names
    assert {"chip_smoke_tp.py", "chip_smoke_pp.py", "chip_smoke_data.py",
            os.path.join("scripts", "trace_pipeline.py")} <= names
    assert {os.path.join("vlp_tpu_torch", *f) for f in (
        ("data", "tables.py"), ("data", "datasets.py"), ("data", "png.py"),
        ("data", "caption_generator.py"), ("native", "__init__.py"))} \
        <= names
    assert {os.path.join("vlp_tpu_torch", *f) for f in (
        ("eval", "plotting.py"), ("eval", "replot.py"),
        ("eval", "linear_probe_eval.py"), ("eval", "results_table.py"),
        ("eval", "latex.py"), ("eval", "eda.py"),
        ("data", "dicom_tools.py"), ("data", "base.py"))} <= names
    assert "chip_smoke_eval.py" in names
    assert {"chip_smoke_weights.py",
            os.path.join("vlp_tpu_torch", "utils", "hf_files.py"),
            os.path.join("vlp_tpu_torch", "models", "torch_import.py")} \
        <= names


IMPORTS_MATPLOTLIB = re.compile(r"^(\s*)(import|from)\s+matplotlib\b",
                                re.MULTILINE)


def test_matplotlib_is_imported_only_inside_functions():
    """No module-level matplotlib import anywhere in the port: every one is
    indented, inside the function that draws."""
    assert IMPORTS_MATPLOTLIB.search("    import matplotlib\n")
    for path in _port_sources():
        with open(path) as fh:
            for m in IMPORTS_MATPLOTLIB.finditer(fh.read()):
                assert m.group(1), path


IMPORTS_HF = re.compile(r"^(\s*)(import|from)\s+(transformers|"
                        r"huggingface_hub|safetensors|tokenizers|"
                        r"torchxrayvision)\b", re.MULTILINE)


def test_hf_packages_are_never_imported_and_xrv_only_in_a_function():
    """The HF files are read by the port's own code; the optional
    ``torchxrayvision`` package only inside the function that falls back
    to it."""
    assert IMPORTS_HF.search("from safetensors.torch import load_file\n")
    found = []
    for path in _port_sources():
        with open(path) as fh:
            for m in IMPORTS_HF.finditer(fh.read()):
                assert m.group(3) == "torchxrayvision" and m.group(1), path
                found.append(os.path.relpath(path, REPO))
    assert found == [os.path.join("vlp_tpu_torch", "models",
                                  "torch_import.py")]


def test_port_sources_never_import_jax():
    for path in _port_sources():
        with open(path) as fh:
            assert not IMPORTS_JAX.search(fh.read()), path


def test_port_sources_never_import_yaml_or_sklearn():
    assert IMPORTS_HOST.search("    import yaml\n")
    assert IMPORTS_HOST.search("from sklearn.ensemble import x\n")
    for path in _port_sources():
        with open(path) as fh:
            assert not IMPORTS_HOST.search(fh.read()), path


def test_sweep_flops_and_setup_check_run_with_the_host_stack_absent(
        tmp_path):
    """The sweep entry point's wandb handoff and a sweep file read, a FLOP
    count and ``setup_check --device cpu`` where none of JAX, PyYAML,
    scikit-learn, pandas, cv2 or the JAX package can be imported."""
    code = (
        "import json, sys\n"
        f"sys.modules.update(dict.fromkeys({FORBIDDEN + ('vlp_tpu',)!r}))\n"
        "import torch\n"
        "from vlp_tpu_torch.train import sweep\n"
        "from vlp_tpu_torch.utils.flops import analytic_flops\n"
        "from vlp_tpu_torch import setup_check\n"
        f"assert sweep.main([{SWEEP!r}, '--emit-wandb', 'w.yaml']) == 0\n"
        "assert json.load(open('w.yaml'))['method'] == 'bayes'\n"
        f"assert sweep.load_sweep({SWEEP!r})['metric']['goal'] == "
        "'minimize'\n"
        "assert analytic_flops(torch.mm, torch.zeros(4, 8), "
        "torch.zeros(8, 2)) == 128\n"
        "assert setup_check.main(['--device', 'cpu']) == 0\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SETUP OK" in out.stdout


def test_port_sources_never_import_the_jax_package():
    assert IMPORTS_VLP_TPU.search("    from vlp_tpu.data import x\n")
    assert IMPORTS_VLP_TPU.search("import vlp_tpu\n")
    assert not IMPORTS_VLP_TPU.search("from vlp_tpu_torch import serve\n")
    for path in _port_sources():
        with open(path) as fh:
            assert not IMPORTS_VLP_TPU.search(fh.read()), path


def test_serving_files_and_the_cli_load_no_jax_package(tmp_path):
    """The serving path end to end on the CPU (NesT-Small, two PNGs through
    ``predict_files``) and the CLI's parsing of a ViT experiment load none
    of JAX, pandas, scikit-learn or the JAX package; cv2 may load, as the
    decoder."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"{i}.png"))
        cv2.imwrite(paths[-1], rng.integers(0, 256, (40, 30), np.uint8))
    code = (
        "import sys\n"
        "from vlp_tpu_torch.config import EXPERIMENTS\n"
        "from vlp_tpu_torch.serve import Predictor, parse_args\n"
        "p = Predictor(EXPERIMENTS['baseline_only_imaging_nest_small'], "
        "None, 128.0, 64.0, batch_size=2, device='cpu')\n"
        f"probs = p.predict_files({paths!r})\n"
        "assert probs.shape == (2,) and ((probs > 0) & (probs < 1)).all()\n"
        "_, cfg = parse_args(['--weights', 'w.npz', '--images', 'dir', "
        "'experiment=baseline_only_imaging_vit_base'])\n"
        "assert cfg.model == 'vit_base_patch16_224'\n"
        "bad = ('jax', 'flax', 'pandas', 'sklearn')\n"
        "print([m for m in sys.modules if m.split('.')[0] in bad "
        "or m.split('.')[0] == 'vlp_tpu'])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_kernel_loader_without_nvcc_raises(monkeypatch, tmp_path):
    from vlp_tpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library()
    assert not (tmp_path / "build").exists()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    from vlp_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path()
    assert first == _build.library_path()
    (csrc / "a.cu").write_text("// two\n")
    assert _build.library_path() != first


def test_training_cli_starts_with_jax_and_the_host_stack_absent(tmp_path):
    """``python -m vlp_tpu_torch.train --help`` where none of JAX, pandas,
    scikit-learn, cv2 or the JAX package can be imported (None in
    ``sys.modules``: an import raises, ``find_spec`` finds nothing), and
    the config it parses from a command line."""
    code = (
        "import runpy, sys\n"
        f"sys.modules.update(dict.fromkeys({FORBIDDEN + ('vlp_tpu',)!r}))\n"
        "from vlp_tpu_torch.train.driver import Config, apply_overrides\n"
        "cfg = apply_overrides(Config(), ['experiment=pretrain_resnet34_"
        "tinybert', 'data.name=synthetic_pretrain'])\n"
        "assert cfg.model.text_model == 'tinybert'\n"
        "sys.argv = ['vlp_tpu_torch.train', '--help']\n"
        "runpy.run_module('vlp_tpu_torch.train', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout


def test_fusion_and_eval_modules_load_with_the_host_stack_absent(tmp_path):
    """The fusion heads, the eval package, the console entry points and
    ``python -m vlp_tpu_torch.eval.test_eval --help`` where none of JAX,
    pandas, scikit-learn, matplotlib, cv2 or the JAX package can be
    imported; a fusion model serves and its subgroup table is written."""
    blocked = FORBIDDEN + ("matplotlib", "vlp_tpu")
    code = (
        "import runpy, sys\n"
        f"sys.modules.update(dict.fromkeys({blocked!r}))\n"
        "import numpy as np\n"
        "import vlp_tpu_torch.models.heads, vlp_tpu_torch.eval, "
        "vlp_tpu_torch.cli\n"
        "from vlp_tpu_torch.config import EXPERIMENTS\n"
        "from vlp_tpu_torch.eval.subgroup import evaluate_results, "
        "predictions_frame\n"
        "from vlp_tpu_torch.data.synthetic import make_synthetic_downstream\n"
        "from vlp_tpu_torch.serve import Predictor\n"
        "import dataclasses\n"
        "cfg = dataclasses.replace(EXPERIMENTS['baseline_fusion_resnet34'], "
        "model='resnet_micro', image_size=16)\n"
        "p = Predictor(cfg, None, 128.0, 64.0, batch_size=2, device='cpu')\n"
        "imgs = np.zeros((3, 16, 16), np.uint8)\n"
        "probs = p.predict_arrays(imgs, np.ones((3, 15), np.float32))\n"
        "samples, _ = make_synthetic_downstream(3, 16)\n"
        "evaluate_results('t.csv', [predictions_frame(probs, samples)])\n"
        "sys.argv = ['test_eval', '--help']\n"
        "try:\n"
        "    runpy.run_module('vlp_tpu_torch.eval.test_eval', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--checkpoints" in out.stdout and "--device" in out.stdout
    assert (tmp_path / "t.csv").read_text().startswith(
        "level,group,fold,metric,value\n")


def test_real_data_path_runs_with_the_host_stack_absent(tmp_path):
    """The real datasets' readers, the frozen split, the numpy PNG reader,
    the C++ route's cache build and both data modules, and the caption
    generator, where none of JAX, pandas, scikit-learn, cv2, PIL or the
    JAX package can be imported."""
    code = (
        "import os, sys\n"
        f"sys.modules.update(dict.fromkeys({FORBIDDEN + ('vlp_tpu',)!r}))\n"
        "from pathlib import Path\n"
        "import torch\n"
        "import chip_smoke_data\n"
        "from vlp_tpu_torch.config import apply_overrides, get_experiment\n"
        "from vlp_tpu_torch.data import caption_generator, preprocess_host\n"
        "from vlp_tpu_torch.data.datamodule import build_datamodule\n"
        "assert preprocess_host.decoder() == 'png (numpy + zlib)'\n"
        "root = Path('corpus')\n"
        "env = chip_smoke_data.write_corpus(root, downstream=40, "
        "pretrain=60, sides=(20, 40))\n"
        "os.environ.update({k: v for k, v in env.items() "
        "if k.endswith('_PATH')})\n"
        "for name in ('baseline_only_imaging_resnet34', "
        "'pretrain_resnet34_tinybert'):\n"
        "    cfg = apply_overrides(get_experiment(name), ["
        "'data.image_size=32', 'data.batch_size=16', "
        "'data.eval_batch_size=16', f'output_dir=out_{name}'])\n"
        "    chip_smoke_data.seed_cache(root, Path(cfg.output_dir) / "
        "'datacache')\n"
        "    fold = next(build_datamodule(cfg, torch.device('cpu')).folds())\n"
        "    batch = next(iter(fold.train_loader))\n"
        "    assert batch['image_u8'].shape[1:] == (32, 32)\n"
        "caption_generator.main('gen/captions.csv')\n"
        "bad = ('jax', 'pandas', 'sklearn', 'cv2', 'PIL')\n"
        "print([m for m in sys.modules if sys.modules[m] is not None and "
        "(m.split('.')[0] in bad or m.split('.')[0] == 'vlp_tpu')])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    assert (tmp_path / "gen" / "captions.csv").read_bytes().startswith(
        b"anatomy_site,abnormality_label,caption\n")


def test_eval_tools_run_with_the_host_stack_absent(tmp_path):
    """The evaluation tools where none of JAX, pandas, scikit-learn,
    PyYAML, cv2, PIL, matplotlib or the JAX package can be imported: the
    silhouettes and the confusion counts returned with one line naming
    each figure not drawn, a sweep's LaTeX, a dataset report, the
    windowing and its PNG, and the command lines' help."""
    sweep = os.path.join(REPO, "configs", "sweeps", "pretrain", "vlp.yaml")
    code = (
        "import runpy, sys\n"
        f"sys.modules.update(dict.fromkeys({FORBIDDEN + ('vlp_tpu',)!r}))\n"
        "import numpy as np, torch\n"
        "from vlp_tpu_torch.eval import eda, latex, plotting\n"
        "from vlp_tpu_torch.data import dicom_tools, png\n"
        "import vlp_tpu_torch.data.base\n"
        "x = torch.randn(12, 5)\n"
        "y = torch.tensor([0, 1] * 6)\n"
        "s = plotting.plot_tsne_and_silhouette(x, y, ['a'] * 6 + ['b'] * 6,"
        " 'p/tsne.png')\n"
        "assert set(s) == {'silhouette_tumor', 'silhouette_dataset'}\n"
        "cm = plotting.plot_confusion_matrix(torch.rand(12), y, "
        "'p/cm.png')\n"
        "assert cm.sum() == 12\n"
        f"assert latex.main(['space', {sweep!r}]) == 0\n"
        "r = eda.dataset_report([{'tumor': 1, 'sex': 'M'}, {'tumor': 0}])\n"
        "assert r['sex_counts'] == {'M': 1}\n"
        "assert eda.plot_distributions([{'tumor': 1, 'sex': 'M'}], "
        "'e') == []\n"
        "png.write_png('w.png', dicom_tools.window_to_uint8("
        "np.arange(12).reshape(3, 4)))\n"
        "assert png.read_png('w.png').shape == (3, 4, 1)\n"
        "for mod in ('replot', 'linear_probe_eval', 'results_table'):\n"
        "    sys.argv = [mod, '--help']\n"
        "    try:\n"
        "        runpy.run_module(f'vlp_tpu_torch.eval.{mod}', "
        "run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0\n"
        "print([m for m in sys.modules if sys.modules[m] is not None and "
        f"m.split('.')[0] in {FORBIDDEN + ('vlp_tpu',)!r}])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    for name in ("p/tsne.png", "p/cm.png", "e/dist_sex.png"):
        assert f"matplotlib is not installed: {name} is not drawn" \
            in out.stderr
    assert not (tmp_path / "p").exists()
    assert "--checkpoint" in out.stdout and "--csv" in out.stdout
