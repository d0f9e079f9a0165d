"""The port, and the scripts and tests that run it on a card (where JAX is not
installed), import neither JAX, optax nor anything of the JAX package, nor
OpenCV or PIL, which the card's machine lacks."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gaustar_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_step.py", ROOT / "tests" / "test_torch_kernels_gpu.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "gaustar_tpu", "cv2", "PIL")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_port_has_modules():
    names = {p.relative_to(ROOT / "gaustar_tpu_torch").as_posix() for p in PORT_FILES if "gaustar_tpu_torch" in p.parts}
    for required in ("cameras.py", "bridge.py", "ops/blend_cuda.py", "ops/binning.py",
                     "models/sugar.py", "train/refine.py", "train/optimizer.py",
                     "ops/image.py", "tools/geometry.py", "train/topo_detect.py", "mesh/tsdf.py",
                     "mesh/surgery.py", "train/mesh_update.py", "train/sequence.py",
                     "models/neural_field.py", "train/init_mesh.py", "tools/mesh_render.py", "tools/raft.py",
                     "tools/depth_fusion.py", "ops/knn.py", "models/gaussians.py", "train/densifier.py",
                     "train/train_gaussians.py", "models/compositor.py", "eval/metrics.py", "eval/lpips_convert.py",
                     "parallel/launch.py", "parallel/collectives.py", "parallel/sharding.py", "parallel/gauss2d.py",
                     "parallel/gauss_shard.py", "tools/registration.py", "tools/network_gui.py",
                     "tools/cmr_convert.py", "utils/profiling.py", "refscale/scenes.py", "refscale/frame.py",
                     "refscale/seq.py", "refscale/real.py", "refscale/warp160.py",
                     "refscale/field_init.py", "refscale/field_batch.py", "demo.py", "bench.py",
                     "bench_scaling.py"):
        assert required in names
