"""CNN-accelerator taxonomy (paper §5.1).

Three orthogonal axes:

* **Data processing style** — how much of a convolution one BasicUnit covers:
  Sconv (a whole 2D conv per iteration), SSconv (part of a 2D conv),
  Mconv (multiple 2D convs per iteration).
* **Data propagation type** — which operand moves between PEs:
  OP (ofmaps/psums propagate, filters fixed), IP (ifmaps propagate,
  ofmaps fixed), MP (multiple kinds propagate).
* **Register allocation** — DR (registers dispersed per-PE) vs
  CR (concentrated storage, never holds psums).

The paper instantiates three corners for HMAI:
  SconvOD = Sconv-OP-DR (NeuFlow-style), SconvIC = SSconv-IP-CR
  (ShiDianNao-style), MconvMC = Mconv-MP-CR (Origami-style).

TPU adaptation (see DESIGN.md): per-PE registers/FIFOs have no TPU
analogue; the surviving dimension is *stationarity* — which operand a
Pallas kernel keeps resident in VMEM across its inner grid loop.  The
mapping below ties each archetype to its Pallas kernel in the JAX
package's ``kernels.conv_dataflow``.  The port keeps each archetype's
stationary operand in its CUDA kernel (``repro_torch.kernels.conv_dataflow``):
SconvOD the filter taps in shared memory, SconvIC the output band in
registers over a cp.async-staged halo window, MconvMC the accumulator of
an im2col GEMM.
"""
from __future__ import annotations

import dataclasses
import enum


class DataProcessing(enum.Enum):
    SCONV = "Sconv"      # whole 2D conv per BasicUnit
    SSCONV = "SSconv"    # part of a 2D conv per BasicUnit
    MCONV = "Mconv"      # multiple 2D convs per BasicUnit


class Propagation(enum.Enum):
    OP = "ofmaps"        # psums propagate between PEs, filters fixed
    IP = "ifmaps"        # ifmaps propagate, ofmaps fixed in PEs
    MP = "multiple"      # more than one operand propagates


class RegisterAlloc(enum.Enum):
    DR = "dispersive"    # per-PE registers
    CR = "concentrated"  # central register file, never stores psums


@dataclasses.dataclass(frozen=True)
class AcceleratorArch:
    name: str
    processing: DataProcessing
    propagation: Propagation
    registers: RegisterAlloc
    exemplar: str            # the published design it abstracts
    tpu_stationarity: str    # Pallas-kernel analogue (VMEM-resident operand)
    uses_ocb: bool           # on-chip buffer (Table 10: only Mconv)
    macs_per_pe: int         # Table 10: 1 for Sconv/SSconv, >1 for Mconv

    def validate(self) -> None:
        # Table 10 invariants
        if self.processing in (DataProcessing.SCONV, DataProcessing.SSCONV):
            assert self.macs_per_pe == 1, "Sconv/SSconv: 1 MAC per PE"
            assert not self.uses_ocb, "Sconv/SSconv: no on-chip buffer"
        else:
            assert self.macs_per_pe > 1, "Mconv: multiple MACs per PE"
            assert self.uses_ocb, "Mconv: requires on-chip buffer"


SCONV_OD = AcceleratorArch(
    name="SconvOD",
    processing=DataProcessing.SCONV,
    propagation=Propagation.OP,
    registers=RegisterAlloc.DR,
    exemplar="NeuFlow (Farabet et al., CVPRW'11)",
    tpu_stationarity="weight-stationary",
    uses_ocb=False,
    macs_per_pe=1,
)

SCONV_IC = AcceleratorArch(
    name="SconvIC",
    processing=DataProcessing.SSCONV,
    propagation=Propagation.IP,
    registers=RegisterAlloc.CR,
    exemplar="ShiDianNao (Du et al., ISCA'15)",
    tpu_stationarity="output-stationary",
    uses_ocb=False,
    macs_per_pe=1,
)

MCONV_MC = AcceleratorArch(
    name="MconvMC",
    processing=DataProcessing.MCONV,
    propagation=Propagation.MP,
    registers=RegisterAlloc.CR,
    exemplar="Origami (Cavigelli & Benini, TCSVT'17)",
    tpu_stationarity="im2col-GEMM (MXU tiles)",
    uses_ocb=True,
    macs_per_pe=4,
)

TAXONOMY = {a.name: a for a in (SCONV_OD, SCONV_IC, MCONV_MC)}
for _a in TAXONOMY.values():
    _a.validate()
