"""Mamba-2 SSD chunked scan: CUDA kernel (kernel.py, csrc/), its plain
versions (ref.py) and the device-routing ``ssd_scan`` (ops.py)."""
from .ops import ssd_scan  # noqa: F401
from .ref import ssd_ref, ssd_scan_ref  # noqa: F401
