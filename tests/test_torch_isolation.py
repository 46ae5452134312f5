"""The PyTorch port, chip_smoke.py and the port's tools must not import JAX
or the JAX package, not even its NumPy-only modules, nor PIL or matplotlib,
which the CUDA card's machine does not have."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "my_lidar_graph_slam_tpu_torch"
SOURCES = sorted(p for p in PKG.rglob("*.py")
                 if "build" not in p.relative_to(PKG).parts) + \
    [ROOT / "chip_smoke.py",
     ROOT / "tools" / "replay_detections_torch.py",
     ROOT / "tools" / "kernel_ab.py", ROOT / "tools" / "compare_modes.py",
     ROOT / "tools" / "bb_frontier_caps.py",
     ROOT / "tools" / "keyframe_ranges.py"]
FORBIDDEN = ("jax", "jaxlib", "my_lidar_graph_slam_tpu", "PIL", "matplotlib")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "__import__" and \
                node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_sources_found():
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"
