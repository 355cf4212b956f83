"""ctypes binding of the SSD scan CUDA kernels (``csrc/ssd_scan.cu``).

``ssd_scan_cuda`` checks its operands, allocates the outputs and the
workspace, and launches the scan (three kernels: chunk states, the carry
over chunks, the chunk outputs) on PyTorch's current stream without
synchronising.  ``launches`` counts its successful calls, so a run can
show that its SSD scans went through the kernels; ``ssd_plan`` describes
a call's grids.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 64      # P
MAX_STATE_DIM = 128    # N
MAX_CHUNK = 4096

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_launch.argtypes = ([_P] * 7 + [ctypes.c_longlong]
                                        + [_I] * 7 + [_P])
        lib.ssd_scan_launch.restype = _I
        lib.ssd_scan_workspace.argtypes = [_I] * 6
        lib.ssd_scan_workspace.restype = ctypes.c_longlong
        lib.ssd_scan_plan.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
        lib.ssd_scan_plan.restype = _I
        lib.ssd_scan_error_string.argtypes = [_I]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def workspace_floats(b, s, h, p, n, chunk) -> int:
    """fp32 words of workspace one call at this shape needs."""
    return int(_lib().ssd_scan_workspace(b, s, h, p, n, chunk))


def ssd_plan(b, s, h, p, n, chunk) -> str:
    """The kernels and grids of one call on the current device."""
    lib = _lib()
    out = (_I * 7)()
    rc = lib.ssd_scan_plan(b, s, h, p, n, chunk, out)
    if rc != 0:
        raise RuntimeError(lib.ssd_scan_error_string(rc).decode())
    kernels, g1, g2, g3, hg, nqt, nc = out
    return (f"{kernels} kernels: chunk states {g1} blocks ({b} x {nc} "
            f"chunks x {h} heads), carry {g2} blocks, chunk outputs {g3} "
            f"blocks ({b} x {nc} chunks x {nqt} query tiles x "
            f"{-(-h // hg)} head groups of {hg})")


def _check(u, a, Bm, Cm, chunk):
    if u.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda takes CUDA tensors, got {u.device}")
    for name, x in (("a", a), ("Bm", Bm), ("Cm", Cm)):
        if x.device != u.device:
            raise ValueError(f"{name} is on {x.device}, expected {u.device}")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"u has dtype {u.dtype}, expected float32 or "
                         f"bfloat16")
    if Bm.dtype != u.dtype or Cm.dtype != u.dtype:
        raise ValueError(f"Bm / Cm have dtypes {Bm.dtype} / {Cm.dtype}, "
                         f"expected u's {u.dtype}")
    if a.dtype != torch.float32:
        raise ValueError(f"a has dtype {a.dtype}, expected float32")
    if u.dim() != 4 or a.dim() != 3 or Bm.dim() != 3 or Cm.shape != Bm.shape:
        raise ValueError(f"expected u [B,S,H,P], a [B,S,H], Bm / Cm [B,S,N], "
                         f"got {tuple(u.shape)}, {tuple(a.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    b, s, h, p = u.shape
    if tuple(a.shape) != (b, s, h) or tuple(Bm.shape[:2]) != (b, s):
        raise ValueError(f"a {tuple(a.shape)} or Bm {tuple(Bm.shape)} does "
                         f"not match u {tuple(u.shape)}")
    n = Bm.shape[2]
    if not (1 <= p <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE_DIM):
        raise ValueError(f"P = {p}, N = {n}: the kernel takes P <= "
                         f"{MAX_HEAD_DIM} and N <= {MAX_STATE_DIM}")
    if min(b, s, h) < 1 or chunk < 1 or min(chunk, s) > MAX_CHUNK:
        raise ValueError(f"no launch for u {tuple(u.shape)} at chunk "
                         f"{chunk}")
    if not all(x.is_contiguous() for x in (u, a, Bm, Cm)):
        raise ValueError("u, a, Bm and Cm must be contiguous")
    if u.numel() >= 2 ** 31 or Bm.numel() >= 2 ** 31:
        raise ValueError("tensors past 2**31 elements are not supported")


def ssd_scan_cuda(u: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, *, chunk: int):
    """The chunked SSD scan in chunks of min(chunk, S) rows.

    u [B,S,H,P] (P <= 64), a [B,S,H] float32, Bm / Cm [B,S,N] (N <= 128)
    in u's dtype (float32 or bfloat16), shared by the H heads, on one CUDA
    device.  Returns (y [B,S,H,P] in u's dtype, final state [B,H,N,P]
    float32).
    """
    _check(u, a, Bm, Cm, chunk)
    b, s, h, p = u.shape
    n = Bm.shape[2]
    lib = _lib()
    y = torch.empty_like(u)
    sfin = torch.empty(b, h, n, p, dtype=torch.float32, device=u.device)
    ws = torch.empty(lib.ssd_scan_workspace(b, s, h, p, n, chunk),
                     dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.ssd_scan_launch(
            u.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), sfin.data_ptr(), ws.data_ptr(), ws.numel(), b, s,
            h, p, n, chunk, int(u.dtype == torch.bfloat16), stream)
    if rc != 0:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan launch failed: {msg}")
    global launches
    launches += 1
    return y, sfin
