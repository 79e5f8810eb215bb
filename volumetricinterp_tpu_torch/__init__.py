"""volumetricinterp_tpu_torch — the PyTorch / CUDA port of volumetricinterp_tpu.

Regularized weighted least-squares fits of AMISR radar point measurements
to a spherical-cap-harmonic x Laguerre basis (or Gaussian radial basis
functions, models/radbasfun.py), coefficient files in the reference HDF5
schema, evaluation of the fitted model at points and on dense grids, and
leave-one-beam-out model selection (sweep.py) — on an NVIDIA H100, or on
several cards over torch.distributed (parallel/).

* The fit runs in float64 torch on the chosen device (ops/fit.py).
* Dense grids run through a hand-written Hopper kernel
  (csrc/grid_eval.cu, launched by ops/grid_eval_cuda.py), the port of the
  JAX package's Pallas kernel; on the CPU a plain torch twin of the same
  maths runs instead.
* Devices are explicit: ``Interpolate(config, device="cuda")`` and
  ``Estimate(path, device="cuda")`` default to CUDA and raise when it is
  unavailable; pass ``device="cpu"`` to run on the CPU.

This package imports torch, numpy and scipy, never jax, and h5py only
inside the functions that read or write files.  The JAX package
(volumetricinterp_tpu) is the reference it is tested against.
"""

from .interpolate import Interpolate
from .estimate import Estimate
from .validate import Validate

__version__ = "0.1.0"

__all__ = ["Interpolate", "Estimate", "Validate", "__version__"]
