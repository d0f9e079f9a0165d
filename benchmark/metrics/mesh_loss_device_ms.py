"""Device ms a traced step of the kernels, copies and fills launched inside the
camera-independent losses (`loss.mesh`, train/refine.py:shared_losses: normal
consistency, edge and area isometry, opacity), the span's subtree; read by
benchmark/spans.py from the traced steps run again with the program's spans on."""

from benchmark import spans

CAPTURE = spans.STEP_CAPTURE


def read(run):
    return spans.device_ms(run, "mesh_loss_device_ms")
