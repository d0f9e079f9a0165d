"""Device ms a traced step of the kernels, copies and fills launched inside the
gaussians' centres and covariances from the mesh (`refine.geometry`,
models/sugar.py:geom_primitives) and their colours and depth channel
(`render.colour`, in render_rgbd), the span's subtree; read by
benchmark/spans.py from the traced steps run again with the program's spans on."""

from benchmark import spans

CAPTURE = spans.STEP_CAPTURE


def read(run):
    return spans.device_ms(run, "geometry_device_ms")
