"""Shared fixtures of the port's CPU tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: the plain CPU blend steps over
    small tensors, and beside the suite's other workers more threads only
    contend. Import it into a test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_sugar(jp, jc, device="cpu"):
    """The port's (SuGaRParams, SuGaRConfig) equal to a JAX package's pair
    (any objects with the same fields: the arrays are read with np.asarray)."""
    import dataclasses

    import numpy as np

    from gaustar_tpu_torch import bridge

    fields = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    config = {"faces": np.asarray(jc.faces), "bary": np.asarray(jc.bary), "thickness": np.asarray(jc.thickness),
              "n_gaussians_per_face": jc.n_gaussians_per_face, "sh_levels": jc.sh_levels,
              "min_scale": jc.min_scale, "max_scale": jc.max_scale, "loose_bind": jc.loose_bind,
              "n_verts": len(fields["points"])}
    return bridge.sugar_params_from_numpy(fields, device), bridge.sugar_config_from_numpy(config, device)


def perturbed_gaussians(fields, seed):
    """create_from_pcd's fields ({name: numpy array}) with seeded SH bands,
    opacities, anisotropic log-scales and unnormalised rotations (norms in
    0.5-2), so that every gradient of a vanilla 3DGS render is nonzero."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = len(fields["xyz"])
    q = rng.normal(size=(n, 4))
    q *= rng.uniform(0.5, 2.0, size=(n, 1)) / np.linalg.norm(q, axis=1, keepdims=True)
    return {**{k: np.asarray(v, np.float32) for k, v in fields.items()},
            "features_rest": rng.normal(scale=0.2, size=np.shape(fields["features_rest"])).astype(np.float32),
            "opacity": rng.normal(size=(n, 1)).astype(np.float32),
            "scaling": (np.asarray(fields["scaling"]) + rng.normal(scale=0.3, size=(n, 3))).astype(np.float32),
            "rotation": q.astype(np.float32)}
