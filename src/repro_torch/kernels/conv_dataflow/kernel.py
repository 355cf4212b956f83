"""ctypes bindings of the three conv-dataflow CUDA kernels
(``csrc/mconv_mc.cu``, ``csrc/sconv_ic.cu``, ``csrc/sconv_od.cu``).

``conv2d_cuda`` checks its operands, allocates the output (and, for
SconvOD when its Cin chain is split, the fp32 workspace of the splits),
and launches the chosen dataflow's kernel on PyTorch's current stream
without synchronising.  ``launches`` counts the successful launches per
dataflow, so a run can show that its convolutions went through the
kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

DATAFLOWS = ("SconvOD", "SconvIC", "MconvMC")
SOURCES = {"SconvOD": "sconv_od", "SconvIC": "sconv_ic",
           "MconvMC": "mconv_mc"}

launches = dict.fromkeys(DATAFLOWS, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib(dataflow: str) -> ctypes.CDLL:
    name = SOURCES[dataflow]
    lib = build.load(name)
    if not getattr(lib, "_typed", False):
        fn = getattr(lib, f"{name}_launch")
        ws = [_P] if dataflow == "SconvOD" else []
        fn.argtypes = [_P, _P, _P] + ws + [_I] * 9 + [_P]
        fn.restype = _I
        if dataflow == "SconvOD":
            lib.sconv_od_splits.argtypes = [_I] * 8
            lib.sconv_od_splits.restype = _I
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, stride: int):
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_cuda takes CUDA tensors, got {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, expected {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x has dtype {x.dtype}, expected float32 or "
                         f"bfloat16")
    if w.dtype != x.dtype:
        raise ValueError(f"w has dtype {w.dtype}, expected {x.dtype}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"expected x [N,H,W,Cin] and w [KH,KW,Cin,Cout], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    n, h, wd, cin = x.shape
    kh, kw, cin2, cout = w.shape
    if cin != cin2:
        raise ValueError(f"x has {cin} channels, w expects {cin2}")
    if stride < 1 or h < kh or wd < kw or min(n, cin, cout) < 1:
        raise ValueError(f"no VALID output for x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, stride {stride}")
    if x.numel() >= 2 ** 31 or w.numel() >= 2 ** 31:
        raise ValueError("tensors past 2**31 elements are not supported")


def sconv_od_splits(x_shape, w_shape, stride: int = 1) -> int:
    """G, the number of splits of SconvOD's Cin chain at this shape (1: not
    split).  The kernel's own plan decides it; 0 for a shape it does not
    take."""
    n, h, wd, cin = x_shape
    kh, kw, _, cout = w_shape
    return _splits(n, h, wd, cin, kh, kw, cout, stride)


@functools.lru_cache(maxsize=None)
def _splits(*shape: int) -> int:
    # one ctypes call per shape: the pools call SconvOD at a few shapes
    # many times, and are bound by the host
    return _lib("SconvOD").sconv_od_splits(*shape)


def conv2d_cuda(x: torch.Tensor, w: torch.Tensor, *, dataflow: str,
                stride: int = 1) -> torch.Tensor:
    """VALID convolution at ``stride`` through one dataflow's kernel.

    x [N,H,W,Cin], w [KH,KW,Cin,Cout], both float32 or both bfloat16 on
    one CUDA device -> [N, (H-KH)//stride+1, (W-KW)//stride+1, Cout] in
    x's dtype.  The JAX wrapper's tiles are fixed in the kernels: SconvIC
    bands of 8 output rows; SconvOD plans its channel tiles and Cin splits
    from the shape (``sconv_od_splits``).
    """
    if dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r}")
    _check(x, w, stride)
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    lib = _lib(dataflow)
    name = SOURCES[dataflow]
    out = torch.empty(n, (h - kh) // stride + 1, (wd - kw) // stride + 1,
                      cout, dtype=x.dtype, device=x.device)
    ws = []
    if dataflow == "SconvOD":
        g = _splits(n, h, wd, cin, kh, kw, cout, stride)
        ws = [torch.empty(g * out.numel() if g > 1 else 0,
                          dtype=torch.float32, device=x.device)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            *[t.data_ptr() for t in ws], n, h, wd, cin, kh, kw, cout,
            stride, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")
    launches[dataflow] += 1
    return out
