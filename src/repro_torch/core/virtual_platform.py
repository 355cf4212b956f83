"""HMAI's heterogeneous accelerators as *virtual accelerator pools* on the
GPU (the port of the JAX package's ``core/virtual_platform.py``).

Each pool serves one perception-workload class with the dataflow
archetype that suits it (the paper's SconvOD / SconvIC / MconvMC
affinities): every convolution the pool runs goes through that
archetype's kernel (``convnet_apply(..., dataflow=spec.archetype)``), so
``det-large`` measures MconvMC, ``det-small`` SconvOD and ``tracking``
SconvIC.  The FlexAI scheduler drives the pools through the same queue
interface as the simulated HMAI: each pool advertises a *measured* FPS
per model class (calibrated at start-up by timing a warm batch), and
``execute`` really runs the batch.

On one GPU every pool runs on the same card; a pool's identity is its
archetype (and its ``n_devices`` multiplier on the measured rate, kept
from the JAX package, where a pool was a group of devices).

``DEFAULT_POOLS`` are the JAX package's: nets at width 0.1 on 64x64 and
32x32 frames, small enough that a call is bound by the host's launches
and the pools' rates hardly differ.  ``FULL_WIDTH_POOLS`` run every net
at its full width and input size (YOLO 416², SSD 512², GOTURN 227²), where
the device time of each archetype's kernel sets the pool's rate.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import hmai as H
from repro_torch.kernels.protocol import resolve_device, synchronize


@dataclasses.dataclass
class PoolSpec:
    name: str
    archetype: str          # taxonomy archetype this pool emulates
    n_devices: int
    batch_size: int = 4
    # reduced CNNs, as in the JAX package; None: each net at full width
    width_mult: float | None = 0.1


class _ModelBank:
    """The perception nets every pool runs, built once per (seed, width,
    batch, device): weights from a ``torch.Generator`` seeded with
    ``seed``, and all-zero input batches: 64x64 (YOLO, SSD) and 32x32
    (GOTURN) for a reduced width, each net's own input size at full
    width (``width_mult=None``)."""

    _instances: dict = {}

    def __init__(self, seed: int, width_mult: float, batch_size: int,
                 device: torch.device):
        from repro_torch.models.perception.cnn import (convnet_apply,
                                                       init_convnet)
        from repro_torch.models.perception.nets import (PERCEPTION_SPECS,
                                                        goturn_apply,
                                                        init_goturn)
        from repro_torch.models.perception.stats import SSD_SPEC, YOLO_SPEC
        if width_mult is None:
            widths = {k: w for k, (_, w) in PERCEPTION_SPECS.items()}
            sizes = {k: s.input_hw for k, (s, _) in PERCEPTION_SPECS.items()}
        else:
            widths = {"yolo": width_mult, "ssd": width_mult,
                      "goturn": max(0.2, width_mult)}
            sizes = {"yolo": 64, "ssd": 64, "goturn": 32}
        gen = torch.Generator().manual_seed(seed)
        self.params = {
            "yolo": init_convnet(gen, YOLO_SPEC, widths["yolo"],
                                 device=device),
            "ssd": init_convnet(gen, SSD_SPEC, widths["ssd"], device=device),
            "goturn": init_goturn(gen, widths["goturn"], device=device),
        }
        self.fns = {
            "yolo": lambda p, x, df: convnet_apply(p, YOLO_SPEC, x,
                                                   dataflow=df),
            "ssd": lambda p, x, df: convnet_apply(p, SSD_SPEC, x,
                                                  dataflow=df),
            "goturn": lambda p, x, df: goturn_apply(p, x, x, dataflow=df),
        }
        self.inputs = {k: torch.zeros(batch_size, hw, hw, 3, device=device)
                       for k, hw in sizes.items()}

    @classmethod
    def get(cls, seed: int, width_mult: float | None, batch_size: int,
            device: torch.device) -> "_ModelBank":
        key = (seed, width_mult, batch_size, str(device))
        if key not in cls._instances:
            cls._instances[key] = cls(seed, width_mult, batch_size, device)
        return cls._instances[key]


class VirtualAcceleratorPool:
    """One pool serving the shared model bank through its archetype's
    conv kernel."""

    def __init__(self, spec: PoolSpec, device: torch.device, seed: int = 0):
        self.spec = spec
        self.device = device
        self.bank = _ModelBank.get(seed, spec.width_mult, spec.batch_size,
                                   device)
        self.inputs = self.bank.inputs
        self.measured_fps: dict = {}

    def calibrate(self) -> dict:
        """Measure frames/s per model class: one warm call, then 3 timed
        calls closed by a device synchronise."""
        for kind in self.bank.fns:
            x = self.inputs[kind]
            self.run(kind, x)
            synchronize(self.device)
            t0 = time.perf_counter()
            iters = 3
            for _ in range(iters):
                self.run(kind, x)
            synchronize(self.device)
            dt = (time.perf_counter() - t0) / iters
            # a pool of n devices serves n batches concurrently
            self.measured_fps[kind] = (x.shape[0] * self.spec.n_devices) / dt
        return self.measured_fps

    def run(self, kind: str, frames: torch.Tensor) -> torch.Tensor:
        return self.bank.fns[kind](self.bank.params[kind], frames,
                                   self.spec.archetype)

    def as_accelerator_spec(self) -> H.AcceleratorSpec:
        from repro_torch.core.taxonomy import TAXONOMY
        return H.AcceleratorSpec(
            name=f"pool:{self.spec.name}",
            arch=TAXONOMY[self.spec.archetype],
            fps=dict(self.measured_fps),
            power_w=H.ACCELERATOR_SPECS[self.spec.archetype].power_w
            * self.spec.n_devices)


DEFAULT_POOLS = (
    PoolSpec("det-large", "MconvMC", n_devices=1),
    PoolSpec("det-small", "SconvOD", n_devices=1),
    PoolSpec("tracking", "SconvIC", n_devices=1),
)
FULL_WIDTH_POOLS = tuple(dataclasses.replace(p, width_mult=None)
                         for p in DEFAULT_POOLS)


class VirtualPlatform(H.HMAIPlatform):
    """HMAIPlatform whose specs come from measured pool rates and whose
    ``execute`` really runs the batch on the pool.  Runs on ``device``
    (default: the GPU, see
    :func:`repro_torch.kernels.protocol.default_device`)."""

    def __init__(self, pool_specs=DEFAULT_POOLS, seed: int = 0,
                 run_real: bool = True, device=None):
        self.device = resolve_device(device)
        self.pools: list[VirtualAcceleratorPool] = []
        for ps in pool_specs:
            pool = VirtualAcceleratorPool(ps, self.device, seed)
            pool.calibrate()
            self.pools.append(pool)
        super().__init__(specs=[p.as_accelerator_spec() for p in self.pools])
        self.run_real = run_real

    def execute(self, task, accel_index: int):
        if self.run_real:
            pool = self.pools[accel_index]
            pool.run(task.kind.value, pool.inputs[task.kind.value])
            synchronize(self.device)
        return super().execute(task, accel_index)
