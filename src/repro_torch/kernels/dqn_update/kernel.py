"""ctypes binding of the fused TD-update CUDA kernel (``csrc/dqn_td.cu``).

``dqn_td_cuda`` (one lane) and ``dqn_td_lanes_cuda`` (L lanes, one
cluster a lane) check their operands, allocate the outputs, and launch
the kernel on PyTorch's current stream without synchronising.
``launches`` counts successful launches, one a call whatever the lane
count, so a run can show that its TD updates went through the kernel;
``td_plan`` describes the launch at a batch size and lane count.
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
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.dqn_td_max_active_clusters.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.dqn_td_max_active_clusters.restype = ctypes.c_int
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


def max_active_clusters(D: int, A: int, fold_adam: bool) -> int:
    """How many lanes (clusters) of the variant the card runs at once at
    widths (D, A); more lanes queue behind them."""
    lib = _lib()
    out = ctypes.c_int(0)
    rc = lib.dqn_td_max_active_clusters(D, A, int(fold_adam),
                                        ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"dqn_td occupancy query failed: "
                           f"{lib.dqn_td_error_string(rc).decode()}")
    return out.value


def td_plan(B: int, D: int, A: int, lanes: int = 1) -> str:
    """The launch at batch ``B``, widths (D, A) and ``lanes`` lanes:
    clusters, grid, passes and shared memory a block; with more than one
    lane also how many clusters the card holds at once."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    lib.dqn_td_plan(B, out)
    cl, threads, rows, passes = out
    text = (f"cluster of {cl} blocks x {threads} threads (grid {cl})"
            if lanes == 1 else
            f"{lanes} clusters of {cl} blocks x {threads} threads (grid "
            f"{cl * lanes}; {max_active_clusters(D, A, True)} clusters "
            f"active at once)")
    return (f"{text}, {HIDDEN[0] // cl} layer-1 units a rank, {passes} "
            f"pass(es) of {rows} rows, {lib.dqn_td_smem_bytes(D, A)} bytes "
            f"of shared memory a block")


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


def _launch(lanes, batch, eval_w, targ_w, gamma, adam, lr):
    """Check and launch.  ``lanes`` None is the single-lane layout (no
    lane axis anywhere); an int L gives the batch, moments, step and
    outputs a leading [L] axis, and each net one where it has it."""
    global launches
    s, a, r, sn, done = batch
    device = s.device
    if device.type != "cuda":
        raise ValueError(f"the TD kernel takes CUDA tensors, got {device}")
    lead = () if lanes is None else (lanes,)
    if s.dim() != len(lead) + 2:
        raise ValueError(f"s has shape {tuple(s.shape)}, expected "
                         f"{'[L, B, D]' if lead else '[B, D]'}")
    B, D = s.shape[-2:]
    A = eval_w[4].shape[-1]
    if lanes is not None and lanes < 1:
        raise ValueError(f"lanes must be positive, got {lanes}")
    h1, h2 = HIDDEN
    shapes = [(D, h1), (h1,), (h1, h2), (h2,), (h2, A), (A,)]
    f32 = torch.float32
    _check("s", s, lead + (B, D), f32, device)
    _check("s_next", sn, lead + (B, D), f32, device)
    _check("a", a, lead + (B,), torch.int32, device)
    _check("r", r, lead + (B,), f32, device)
    _check("done", done, lead + (B,), f32, device)

    def laned(net):
        return lanes is not None and net[0].dim() == 3

    lane_eval, lane_targ = laned(eval_w), laned(targ_w)
    nets = [("eval", eval_w, lane_eval), ("targ", targ_w, lane_targ)]
    if adam is not None:
        mu, nu, step = adam
        nets += [("mu", mu, bool(lead)), ("nu", nu, bool(lead))]
        _check("step", step, lead, torch.int32, device)
    for net_name, net, per_lane in nets:
        for i, (w, shape) in enumerate(zip(net, shapes)):
            _check(f"{net_name}.p{i}", w, lead + shape if per_lane else shape,
                   f32, device)
    lib = _lib()
    smem = lib.dqn_td_smem_bytes(D, A)
    if smem > SMEM_LIMIT:
        raise ValueError(f"state_dim={D}, n_actions={A} needs {smem} bytes "
                         f"of shared memory, more than {SMEM_LIMIT}")

    loss = torch.empty(lead or (1,), dtype=f32, device=device)
    out = [torch.empty(lead + shape, dtype=f32, device=device)
           for shape in shapes]
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
    rc = lib.dqn_td_launch(arr, lanes or 1, B, D, A, gamma, lr,
                           int(adam is not None), int(lane_eval),
                           int(lane_targ), stream)
    if rc != 0:
        raise RuntimeError(f"dqn_td launch failed: "
                           f"{lib.dqn_td_error_string(rc).decode()}")
    launches += 1
    if adam is None:
        return loss, tuple(out)
    return loss, tuple(out), tuple(out_m), tuple(out_v)


def dqn_td_cuda(s, a, r, sn, done, eval_w, targ_w, *, gamma: float,
                adam=None, lr: float = 0.0):
    """Launch the kernel on CUDA tensors, one lane.

    s/sn [B, D] f32, a [B] i32, r/done [B] f32; ``eval_w``/``targ_w`` are
    six-tuples (w1 [D,256], b1 [256], w2 [256,64], b2 [64], w3 [64,A],
    b3 [A]).  Returns ``(loss [1], grads)`` or, with ``adam=(mu6, nu6,
    step)`` (step a 0-d i32 tensor), ``(loss, new_params, new_mu,
    new_nu)``.
    """
    return _launch(None, (s, a, r, sn, done), eval_w, targ_w, gamma, adam,
                   lr)


def dqn_td_lanes_cuda(s, a, r, sn, done, eval_w, targ_w, *, gamma: float,
                      adam=None, lr: float = 0.0):
    """Launch the kernel on CUDA tensors for L lanes at once.

    s/sn [L, B, D] f32, a [L, B] i32, r/done [L, B] f32.  Each of
    ``eval_w``/``targ_w`` is either shared (the shapes of
    :func:`dqn_td_cuda`, read by every lane) or per lane (a leading [L]
    axis).  ``adam=(mu6, nu6, step)`` is per lane: moments [L, ...], step
    [L] i32.  Returns ``(loss [L], grads [L, ...])`` or ``(loss,
    new_params, new_mu, new_nu)``, all with the lane axis.
    """
    return _launch(s.shape[0] if s.dim() == 3 else -1, (s, a, r, sn, done),
                   eval_w, targ_w, gamma, adam, lr)
