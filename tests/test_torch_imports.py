"""The port stands alone: no file of `dl_ofdm_tpu_torch/` or `chip_smoke.py`
imports JAX or the JAX package, kernels build without PyTorch's extension
machinery, and `chip_smoke.py` refuses to run without a CUDA device or
outside a checkout.  (An AST scan, not `sys.modules`: this image imports
JAX at interpreter start.)"""
import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(glob.glob(os.path.join(ROOT, "dl_ofdm_tpu_torch", "**",
                                           "*.py"), recursive=True))


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_files_found():
    assert len(PORT_FILES) >= 15


@pytest.mark.parametrize(
    "path", PORT_FILES + [os.path.join(ROOT, "chip_smoke.py")],
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "dl_ofdm_tpu"), \
            f"{path} imports {mod}"
        assert "cpp_extension" not in mod, f"{path} imports {mod}"


def test_kernel_sources_are_plain_c_interface():
    sources = glob.glob(os.path.join(ROOT, "dl_ofdm_tpu_torch", "csrc", "*"))
    assert sources
    for path in sources:
        text = open(path).read()
        assert "torch/extension.h" not in text and "ATen" not in text
        assert 'extern "C"' in text


def test_nvcc_missing_raises_clearly(monkeypatch, tmp_path):
    from dl_ofdm_tpu_torch.ops import cuda_build
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit at its default prefix")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_library_named_by_source_hash():
    from dl_ofdm_tpu_torch.ops import cuda_build
    path = cuda_build.library_path("complex_dense")
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.basename(path).startswith("complex_dense-")
    assert path.endswith(".so")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, tmp_path):
        out = _run_smoke(cwd)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
