"""ctypes binding of the fused TD-update CUDA kernel (``csrc/dqn_td.cu``).

``dqn_td_cuda`` checks its operands, allocates the outputs, and launches
the kernel (one thread-block cluster) on PyTorch's current stream without
synchronising.  ``launches`` counts its successful launches, so a run can
show that its TD updates went through the kernel; ``td_plan`` describes
the launch at a batch size.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.flexai.dqn import HIDDEN
from repro_torch.kernels import build

SMEM_LIMIT = 232_448   # bytes of shared memory one block may use (sm_90)

launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("dqn_td")
    if not getattr(lib, "_typed", False):
        lib.dqn_td_launch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        lib.dqn_td_launch.restype = ctypes.c_int
        lib.dqn_td_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dqn_td_smem_bytes.restype = ctypes.c_int
        lib.dqn_td_plan.argtypes = [ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)]
        lib.dqn_td_plan.restype = None
        lib.dqn_td_error_string.argtypes = [ctypes.c_int]
        lib.dqn_td_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def td_plan(B: int, D: int, A: int) -> str:
    """The launch at batch ``B`` and widths (D, A): cluster, grid, passes
    and shared memory a block."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    lib.dqn_td_plan(B, out)
    cl, threads, rows, passes = out
    return (f"cluster of {cl} blocks x {threads} threads (grid {cl}), "
            f"{HIDDEN[0] // cl} layer-1 units a rank, {passes} pass(es) of "
            f"{rows} rows, {lib.dqn_td_smem_bytes(D, A)} bytes of shared "
            f"memory a block")


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dqn_td_cuda(s, a, r, sn, done, eval_w, targ_w, *, gamma: float,
                adam=None, lr: float = 0.0):
    """Launch the kernel on CUDA tensors.

    s/sn [B, D] f32, a [B] i32, r/done [B] f32; ``eval_w``/``targ_w`` are
    six-tuples (w1 [D,256], b1 [256], w2 [256,64], b2 [64], w3 [64,A],
    b3 [A]).  Returns ``(loss [1], grads)`` or, with ``adam=(mu6, nu6,
    step)`` (step a 0-d i32 tensor), ``(loss, new_params, new_mu,
    new_nu)``.
    """
    global launches
    device = s.device
    if device.type != "cuda":
        raise ValueError(f"dqn_td_cuda takes CUDA tensors, got {device}")
    B, D = s.shape
    A = eval_w[4].shape[1]
    h1, h2 = HIDDEN
    shapes = [(D, h1), (h1,), (h1, h2), (h2,), (h2, A), (A,)]
    f32 = torch.float32
    _check("s", s, (B, D), f32, device)
    _check("s_next", sn, (B, D), f32, device)
    _check("a", a, (B,), torch.int32, device)
    _check("r", r, (B,), f32, device)
    _check("done", done, (B,), f32, device)
    nets = [("eval", eval_w), ("targ", targ_w)]
    if adam is not None:
        mu, nu, step = adam
        nets += [("mu", mu), ("nu", nu)]
        _check("step", step, (), torch.int32, device)
    for net_name, net in nets:
        for i, (w, shape) in enumerate(zip(net, shapes)):
            _check(f"{net_name}.p{i}", w, shape, f32, device)
    lib = _lib()
    smem = lib.dqn_td_smem_bytes(D, A)
    if smem > SMEM_LIMIT:
        raise ValueError(f"state_dim={D}, n_actions={A} needs {smem} bytes "
                         f"of shared memory, more than {SMEM_LIMIT}")

    loss = torch.empty(1, dtype=f32, device=device)
    out = [torch.empty(shape, dtype=f32, device=device) for shape in shapes]
    ptrs = [s, a, r, sn, done, *eval_w, *targ_w]
    if adam is None:
        ptrs += [None] * 13 + [loss, *out] + [None] * 12
    else:
        out_m = [torch.empty_like(w) for w in out]
        out_v = [torch.empty_like(w) for w in out]
        ptrs += [*mu, *nu, step, loss, *out, *out_m, *out_v]
    arr = (ctypes.c_void_p * len(ptrs))(
        *[None if p is None else p.data_ptr() for p in ptrs])
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.dqn_td_launch(arr, B, D, A, gamma, lr, int(adam is not None),
                           stream)
    if rc != 0:
        raise RuntimeError(f"dqn_td launch failed: "
                           f"{lib.dqn_td_error_string(rc).decode()}")
    launches += 1
    if adam is None:
        return loss, tuple(out)
    return loss, tuple(out), tuple(out_m), tuple(out_v)
