"""Flash attention: CUDA kernel (kernel.py, csrc/), its plain version
(ref.py) and the device-routing ``flash_attention`` (ops.py)."""
from .ops import flash_attention  # noqa: F401
from .ref import attention_ref, flash_attention_ref  # noqa: F401
