"""fgoicp_tpu_torch: globally-optimal point-cloud registration (Go-ICP) in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package `fgoicp_tpu` (which stays the reference): the
same nested SO(3) x R^3 branch-and-bound with certified bounds and batched
Procrustes ICP, where the JAX package's Pallas TPU kernels become CUDA C++
kernels (`csrc/`, built at first use by `kernels/build.py`) and everything
else is plain torch.  This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

__all__ = [
    "Config", "EngineConfig", "FastGoICP", "GoICP", "icp_register",
    "load_cloud", "read_ply_vertices", "register", "write_ply",
]

from .config import Config, EngineConfig
from .io import load_cloud, read_ply_vertices, write_ply
from .models.goicp import GoICP, register
from .models.icp import icp_register

# Reference-familiar alias (icp::FastGoICP, fgoicp.hpp:10).
FastGoICP = GoICP
