"""ctypes binding of the flash-attention CUDA kernel
(``csrc/flash_attention.cu``).

``flash_attention_cuda`` checks its operands, allocates the output, and
launches the kernel on PyTorch's current stream without synchronising.
``launches`` counts its successful launches, so a run can show that its
attention went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 128

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = (
            [_P] * 4 + [_I] * 7 + [ctypes.c_float, _I, _P])
        lib.flash_attention_launch.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda takes CUDA tensors, got "
                         f"{q.device}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, expected {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, expected "
                             f"{q.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q has dtype {q.dtype}, expected float32 or "
                         f"bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,Sq,H,D] and k, v [B,Skv,K,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    b2, skv, kh, d2 = k.shape
    if b2 != b or d2 != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if kh < 1 or h % kh:
        raise ValueError(f"{kh} KV heads do not divide {h} query heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is past the kernel's "
                         f"{MAX_HEAD_DIM}")
    if min(b, sq, skv) < 1 or b * h > 65535:
        raise ValueError(f"no launch for q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("tensors past 2**31 elements are not supported")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D)) v with the JAX masking.

    q [B, Sq, H, D]; k, v [B, Skv, K, D] with K dividing H (query head h
    reads KV head h // (H // K)); D <= 128; all float32 or all bfloat16 on
    one CUDA device.  Returns [B, Sq, H, D] in q's dtype.
    """
    _check(q, k, v)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, h, kh, d, int(causal), 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg}")
    global launches
    launches += 1
    return out
