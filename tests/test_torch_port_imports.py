"""The port's import boundary and its kernel loader.

The machine with the card has no JAX, pandas, scikit-learn or cv2, so the
serving entry point, the training step and chip_smoke.py must import
without them and without
any module of the JAX package ``vlp_tpu``; and a missing CUDA compiler must
raise, never hand back a plain fallback.
"""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "orbax", "pandas", "sklearn", "cv2")
IMPORTS_JAX = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b",
                         re.MULTILINE)
# `import vlp_tpu`, `import vlp_tpu.x`, `from vlp_tpu(.x) import ...` at any
# indentation (lazy imports too), but not vlp_tpu_torch
IMPORTS_VLP_TPU = re.compile(r"^\s*(import|from)\s+vlp_tpu(?![\w])",
                             re.MULTILINE)


def test_serve_and_chip_smoke_import_without_jax_or_host_pipeline():
    code = ("import sys; import vlp_tpu_torch.serve, "
            "vlp_tpu_torch.train.step, vlp_tpu_torch.models.resnet, "
            "vlp_tpu_torch.models.bert, vlp_tpu_torch.models.vlm, "
            "vlp_tpu_torch.data.tokenize, "
            "vlp_tpu_torch.probes.conv_probe, "
            "vlp_tpu_torch.probes.bn_gemm_probe, "
            "vlp_tpu_torch.probes.mega_probe, "
            "vlp_tpu_torch.probes.mlp_probe, "
            "vlp_tpu_torch.probes.attn_probe, chip_smoke; "
            f"print([m for m in {FORBIDDEN!r} if m in sys.modules] + "
            "[m for m in sys.modules if m.split('.')[0] == 'vlp_tpu'])")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "vlp_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def test_port_sources_never_import_jax():
    for path in _port_sources():
        with open(path) as fh:
            assert not IMPORTS_JAX.search(fh.read()), path


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
