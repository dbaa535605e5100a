"""Nothing under `benchmark/` imports JAX, its libraries or the JAX package
(whole top-level module names: `dl_ofdm_tpu_torch` begins with
`dl_ofdm_tpu`), and the reference imports nothing of the port."""
import ast
import glob
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))
REFERENCE = [f for f in FILES
             if os.path.dirname(f) == os.path.join(BENCH, "reference")]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dl_ofdm_tpu"}


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


def test_files_found():
    assert len(FILES) >= 20 and len(REFERENCE) >= 4


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(
    p, BENCH))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    assert "dl_ofdm_tpu_torch" not in set(top_level_imports(path))
    assert all(m in {"__future__", "contextlib", "dataclasses", "math",
                     "numpy", "torch", "benchmark"}
               for m in top_level_imports(path))


def test_whole_names_are_compared():
    """The port's name begins with the JAX package's and is allowed."""
    src = "import dl_ofdm_tpu_torch.train\nfrom dl_ofdm_tpu_torch import x\n"
    tree = ast.parse(src)
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
             else n.module.split(".")[0] for n in tree.body}
    assert names == {"dl_ofdm_tpu_torch"} and not names & FORBIDDEN
