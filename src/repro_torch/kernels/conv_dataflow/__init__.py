"""The three HMAI conv dataflows: CUDA kernels (kernel.py, csrc/), their
plain version (ref.py) and the device-routing ``conv2d`` (ops.py)."""
from .ops import DATAFLOWS, conv2d  # noqa: F401
from .ref import conv2d_ref  # noqa: F401
