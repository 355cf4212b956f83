"""ctypes bindings of the three conv-dataflow CUDA kernels
(``csrc/mconv_mc.cu``, ``csrc/sconv_ic.cu``, ``csrc/sconv_od.cu``).

``conv2d_cuda`` checks its operands, allocates the output (and the fp32
workspace the kernel's plan asks for: the partial sums of a split
reduction, SconvIC's channel-padded copy of x), and launches the chosen
dataflow's kernel on PyTorch's current stream without synchronising.
``launches`` counts the convolutions per dataflow (one each, also where
the plan adds the kernels that pad x or sum the splits), so a run can
show that its convolutions went through the kernels.
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
        fn.argtypes = [_P] * 4 + [ctypes.c_longlong] + [_I] * 9 + [_P]
        fn.restype = _I
        splits = getattr(lib, f"{name}_splits")
        splits.argtypes = [_I] * 8
        splits.restype = _I
        workspace = getattr(lib, f"{name}_workspace")
        workspace.argtypes = [_I] * 8
        workspace.restype = ctypes.c_longlong
        describe = getattr(lib, f"{name}_describe")
        describe.argtypes = [_I] * 8 + [ctypes.c_char_p, _I]
        describe.restype = _I
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


def _shape(x_shape, w_shape, stride: int) -> tuple:
    n, h, wd, cin = x_shape
    kh, kw, _, cout = w_shape
    return tuple(int(v) for v in (n, h, wd, cin, kh, kw, cout, stride))


@functools.lru_cache(maxsize=None)
def _plan(dataflow: str, device: int, shape: tuple) -> tuple:
    # (G, workspace floats) on the current device, one ctypes call each per
    # device and shape: the pools call each kernel at a few shapes many
    # times, and are bound by the host
    lib, name = _lib(dataflow), SOURCES[dataflow]
    return (getattr(lib, f"{name}_splits")(*shape),
            getattr(lib, f"{name}_workspace")(*shape))


def conv_splits(dataflow: str, x_shape, w_shape, stride: int = 1) -> int:
    """G, the number of splits of the dataflow kernel's reduction (Cin for
    SconvOD and SconvIC, K = KH*KW*Cin for MconvMC) at this shape (1: not
    split) on the current CUDA device.  The kernel's own plan decides it
    from the shape and the card; 0 for a shape it does not take.  Cached
    per device and shape."""
    return _plan(dataflow, torch.cuda.current_device(),
                 _shape(x_shape, w_shape, stride))[0]


def conv_plan(dataflow: str, x_shape, w_shape, stride: int = 1) -> str:
    """The kernel's plan at this shape on the current CUDA device (tile,
    residency, G), as text."""
    buf = ctypes.create_string_buffer(320)
    getattr(_lib(dataflow), f"{SOURCES[dataflow]}_describe")(
        *_shape(x_shape, w_shape, stride), buf, len(buf))
    return buf.value.decode()


def conv2d_cuda(x: torch.Tensor, w: torch.Tensor, *, dataflow: str,
                stride: int = 1) -> torch.Tensor:
    """VALID convolution at ``stride`` through one dataflow's kernel.

    x [N,H,W,Cin], w [KH,KW,Cin,Cout], both float32 or both bfloat16 on
    one CUDA device -> [N, (H-KH)//stride+1, (W-KW)//stride+1, Cout] in
    x's dtype.  SconvIC keeps the JAX wrapper's bands of 8 output rows.
    Each kernel plans its tile and the splits of its reduction from the
    shape (``conv_splits``, ``conv_plan``); a shape its plan does not take
    raises ValueError before any launch.
    """
    if dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r}")
    _check(x, w, stride)
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    lib = _lib(dataflow)
    name = SOURCES[dataflow]
    with torch.cuda.device(x.device):
        g, n_ws = _plan(dataflow, x.device.index,
                        (n, h, wd, cin, kh, kw, cout, stride))
        if g == 0:
            raise ValueError(f"{dataflow}'s plan does not take x "
                             f"{tuple(x.shape)}, w {tuple(w.shape)}, stride "
                             f"{stride}")
        out = torch.empty(n, (h - kh) // stride + 1, (wd - kw) // stride + 1,
                          cout, dtype=x.dtype, device=x.device)
        ws = torch.empty(n_ws, dtype=torch.float32,
                         device=x.device) if n_ws > 0 else None
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), max(n_ws, 0), n, h, wd,
            cin, kh, kw, cout, stride, int(x.dtype == torch.bfloat16),
            stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")
    launches[dataflow] += 1
    return out
