"""The least work of a grid evaluation and the least time the card could
take for it, counted from the configuration's sizes and the inputs alone
(never from an attribute of the program's evaluator).

Per live point (inside the FoV mask) the basis, one multiply per basis
function, and the contraction, one multiply-add per basis function and
record; the float32 coordinates and the uint8 mask of every grid point,
each record's coefficients read once, and every float32 output value
written once.  The bound is the larger of the operations at the float32
peak and the bytes at the memory bandwidth.
"""

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12


def grid_eval_work(npts, live, nrec, nbasis):
    """(flop, bytes) of one evaluation of nrec records on npts grid
    points, live of them inside the mask."""
    flop = live * nbasis + 2 * live * nrec * nbasis
    nbytes = npts * (3 * 4 + 1) + nrec * nbasis * 4 + npts * nrec * 4
    return flop, nbytes


def bound_s(flop, nbytes):
    """The least seconds the card could take."""
    return max(flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S)
