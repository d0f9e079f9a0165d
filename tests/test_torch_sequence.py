"""The topology event as a whole, the port against the JAX package: the
small topology_scene (a 768-face sphere trainee, a blob in the GT of 8 ring
cameras at 96x96) through both packages' chains: refine_one_frame with
detection and loose bind at half, then the sequence driver's mesh-update
block (fusion, detection, surgery, recolour, re-refine). Both graft the
blob; their tracked-face masks and updated face counts agree. The JAX blend
runs as impl="jax", with no face bucketing and no prewarm."""

import dataclasses

import numpy as np
import pytest

from gaustar_tpu.cameras import Camera as JaxCamera
from gaustar_tpu.ops.rasterizer import RasterConfig as JaxRasterConfig
from gaustar_tpu.train import mesh_update as jmu
from gaustar_tpu.train import sequence as jseq
from gaustar_tpu.train import topo_detect as jtd
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.train import sequence as tseq
from gaustar_tpu_torch.train import topo_detect as ttd
from gaustar_tpu_torch.utils.synthetic import topology_scene
from port_helpers import one_thread  # noqa: F401  (autouse)

JAX_RCFG = JaxRasterConfig(max_pairs=1 << 16, chunk=32, max_per_tile=4096, impl="jax")
# The JAX package's end-to-end settings for a coarse 96-pixel rig
# (tests/test_topology_e2e.py), with a short budget and a coarse fusion grid
# so that both chains run in seconds on a CPU.
SEQ = dict(refinement_iterations=8, force_watertight=False, boundary_pad=0.12, update_cc_face_threshold=10,
           unbind_threshold=30, fusion_voxel_size=0.1, fusion_sdf_trunc=0.2, fusion_use_orbit=False,
           fusion_solid_opacity=0.995, spatial_lr_scale=20.0, face_bucket=None, prewarm_programs=False)
DETECT = dict(depth_scalar=3.0, min_observe=2, mesh_prop=10, detect_floor=False, depth_agreement=0.05,
              edge_threshold=0.6, edge_scalar=10.0, voxel_size=0.05)



def _jax_chain(seq, dcfg, sc, cams):
    gi, gd = sc["gt_images"].numpy(), sc["gt_depths"].numpy()
    params, config, data, topo, _ = jseq.refine_one_frame(
        seq, 1, sc["verts"], sc["faces"], sc["colors"], cams, gi, gd, JAX_RCFG, is_first_frame=False,
        detect_cfg=dcfg)
    assert config.loose_bind
    # run_sequence's mesh-update block (gaustar_tpu/train/sequence.py:475-527)
    fusion = jmu.extract_mesh_fusion(
        params, config, data.cameras, JAX_RCFG, voxel_size=seq.fusion_voxel_size, sdf_trunc=seq.fusion_sdf_trunc,
        depth_trunc=seq.fusion_depth_trunc, max_dim=seq.fusion_max_dim,
        simplify_face_num=seq.fusion_simplify_face_num, use_orbit_cameras=seq.fusion_use_orbit,
        solid_opacity=seq.fusion_solid_opacity)
    face_w = jtd.detect_topo_err(params, config, data.cameras, gd, topo, JAX_RCFG, dcfg)
    out = jmu.update_mesh_with_fusion(params, config, fusion, face_w, force_watertight=seq.force_watertight,
                                      boundary_pad=seq.boundary_pad, cc_face_threshold=seq.update_cc_face_threshold)
    assert out["cc_update_num"] >= 1
    um = out["updated_mesh"]
    vc = jseq._recolor_new_vertices(um, out["track_face_mask"], cams, gi, gd, jseq._face_colors_to_vertex(um),
                                    seq.recolor_depth_agreement, seq.max_depth)
    _, config, _, _, hist = jseq.refine_one_frame(
        seq, 1, um.verts.astype(np.float32), um.faces.astype(np.int32), vc, cams, gi, gd, JAX_RCFG,
        is_first_frame=False, pre_sh=None, ref_area_override=out["new_ref_area"],
        num_iterations=seq.refinement_iterations // 2, enable_unbind=False)
    return out, int(config.faces.shape[0])


def test_topology_event_matches_jax():
    sc = topology_scene("cpu", "small")
    jcams = [JaxCamera(R=c.R.numpy(), T=c.T.numpy(), fx=np.float32(c.fx), fy=np.float32(c.fy),
                       cx=np.float32(c.cx), cy=np.float32(c.cy), width=c.width, height=c.height)
             for c in sc["cams"]]
    jseq_cfg, jdcfg = jseq.SequenceConfig(**SEQ), jtd.TopoDetectConfig(**DETECT)
    tseq_cfg = bridge.config_from_fields(tseq.SequenceConfig, dataclasses.asdict(jseq_cfg))
    tdcfg = bridge.config_from_fields(ttd.TopoDetectConfig, dataclasses.asdict(jdcfg))
    jout, j_faces = _jax_chain(jseq_cfg, jdcfg, sc, jcams)

    events = []
    params, config, data, topo, _ = tseq.refine_one_frame(
        tseq_cfg, 1, sc["verts"], sc["faces"], sc["colors"], sc["cams"], sc["gt_images"], sc["gt_depths"],
        sc["raster_cfg"], is_first_frame=False, detect_cfg=tdcfg, log_fn=events.append, device="cpu")
    unbind = [e for e in events if "unbind_changed" in e]
    assert len(unbind) == 1 and unbind[0]["iteration"] == SEQ["refinement_iterations"] // 2
    assert config.loose_bind
    params, config, data, topo, tout = tseq.update_frame_topology(
        tseq_cfg, 1, params, config, data, topo, sc["cams"], sc["gt_images"], sc["gt_depths"], sc["raster_cfg"],
        detect_cfg=tdcfg)
    assert tout["cc_update_num"] >= 1
    assert len(tout["history"]) == 0 or all(np.isfinite(h["loss"]) for h in tout["history"])
    t_faces = int(config.faces.shape[0])
    assert t_faces == len(tout["updated_mesh"].faces) and data.ref_area.shape[0] == t_faces

    t_track, j_track = tout["track_face_mask"], jout["track_face_mask"]
    assert t_track.shape == j_track.shape == (len(sc["faces"]),)
    agree = (t_track == j_track).mean()
    print(f"track agreement {agree:.4f}; tracked {t_track.sum()} / {j_track.sum()}; faces {t_faces} / {j_faces}; "
          f"aabb_pad {tout['aabb_pad']} / {jout['aabb_pad']}")
    assert agree >= 0.97, f"track_face_mask agrees on {agree:.4f} of faces"
    assert abs(t_faces - j_faces) <= 0.03 * j_faces, f"updated faces {t_faces} vs {j_faces}"
    # the tracked prefix stays on the sphere
    um = tout["updated_mesh"]
    tv = um.verts[um.faces[: int(t_track.sum())].reshape(-1)]
    assert np.median(np.abs(np.linalg.norm(tv - np.array([0.0, 0.0, 4.0]), axis=1) - 0.6)) < 0.1


def test_compile_reuse_options_raise():
    for kw in (dict(face_bucket=256), dict(prewarm_programs=True), dict(auto_size_caps=1.2)):
        with pytest.raises(NotImplementedError, match="compile-reuse"):
            tseq.refine_one_frame(tseq.SequenceConfig(**kw), 0, None, None, None, [], None, None, None, True)
