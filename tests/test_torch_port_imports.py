"""The port's import boundary and its kernel loader.

The machine with the card has no JAX, pandas, scikit-learn or cv2, so the
serving entry point and chip_smoke.py must import without them and without
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


def test_serve_and_chip_smoke_import_without_jax_or_host_pipeline():
    code = ("import sys; import vlp_tpu_torch.serve, chip_smoke; "
            f"print([m for m in {FORBIDDEN!r} if m in sys.modules] + "
            "[m for m in sys.modules if m.split('.')[0] == 'vlp_tpu'])")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_port_sources_never_import_jax():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "vlp_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            assert not IMPORTS_JAX.search(fh.read()), path


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
