"""gaustar_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of gaustar_tpu.

Module names mirror `gaustar_tpu/` so each port module sits beside its JAX
counterpart. The package imports torch and numpy only. Its entry points run on
the GPU (`device="cuda"`) unless the caller passes `device="cpu"`; on CPU
tensors the hand-written CUDA kernels are replaced by their plain PyTorch
versions (ops/blend_cuda.py), which is how the CPU tests run the port.
"""

__version__ = "0.1.0"
