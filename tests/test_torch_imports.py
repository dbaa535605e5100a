"""The port stands alone: no file of `dl_ofdm_tpu_torch/`, no
`scripts/torch_*.py` and not `chip_smoke.py` imports JAX or the JAX
package, kernels build without PyTorch's extension machinery, and
`chip_smoke.py` refuses to run without a CUDA device or outside a
checkout.  (An AST scan, not `sys.modules`: this image imports
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
# the port's scripts run on the GPU machine too
SCRIPT_FILES = sorted(glob.glob(os.path.join(ROOT, "scripts", "torch_*.py")))


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


@pytest.mark.parametrize("module", [
    "ops/complex_ops.py", "ops/norms.py", "ops/pallas_kernels.py",
    "channel/fir.py", "models/equalizers.py", "models/receiver.py",
    "train/transfer.py", "train/curriculum.py", "train/equalizer_loop.py",
    "eval/sweep.py", "cli.py", "runner.py", "train/checkpoint.py",
    "utils/__init__.py", "utils/timing.py", "utils/observability.py",
    "baselines/__init__.py", "baselines/pdp.py", "baselines/interp.py",
    "baselines/cp_enhanced.py", "baselines/matlab_link.py",
    "baselines/estimators.py", "baselines/classical_rx.py",
    "eval/mat_export.py", "eval/mat_eval.py", "eval/plots.py",
    "ofdm/papr.py", "ofdm/legacy_tx.py", "channel/awgn.py",
    "channel/legacy.py", "models/dccn.py", "models/e2e_blocks.py",
    "parallel/mesh.py", "parallel/tp.py"])
def test_equalizer_stage_modules_are_scanned(module):
    """The equalizer stage's modules, the entry points (CLI, runner,
    checkpoints, utils), the classical baselines, the rest of eval, the
    ablation and legacy paths and tensor parallelism are among the files
    the import scan reads, and import without JAX's modules being
    reached."""
    path = os.path.join(ROOT, "dl_ofdm_tpu_torch", module)
    assert path in PORT_FILES
    import importlib
    importlib.import_module("dl_ofdm_tpu_torch." + module[:-3].replace(
        "/", "."))


@pytest.mark.parametrize(
    "path", PORT_FILES + SCRIPT_FILES + [os.path.join(ROOT, "chip_smoke.py")],
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "dl_ofdm_tpu"), \
            f"{path} imports {mod}"
        assert "cpp_extension" not in mod, f"{path} imports {mod}"


def test_kernel_sources_are_plain_c_interface():
    """Every source and header under csrc/ stays free of PyTorch's headers;
    every source (`.cu`) has a plain C entry point."""
    files = glob.glob(os.path.join(ROOT, "dl_ofdm_tpu_torch", "csrc", "*"))
    assert any(p.endswith(".cu") for p in files)
    for path in files:
        text = open(path).read()
        assert "torch/extension.h" not in text and "ATen" not in text
        if path.endswith(".cu"):
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


def test_library_digest_follows_headers(monkeypatch, tmp_path):
    """A header's bytes are part of every library's name, so an edited
    header builds anew."""
    from dl_ofdm_tpu_torch.ops import cuda_build
    for name in os.listdir(cuda_build.CSRC_DIR):
        shutil.copy(os.path.join(cuda_build.CSRC_DIR, name), tmp_path)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    before = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    with open(tmp_path / "philox.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    for n in cuda_build.SOURCES:
        assert before[n] != after[n], n
    with open(tmp_path / "fused_synth.cu", "a") as f:
        f.write("// edited\n")
    assert cuda_build.library_path("fused_synth") != after["fused_synth"]
    assert cuda_build.library_path("fused_model") == after["fused_model"]


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
