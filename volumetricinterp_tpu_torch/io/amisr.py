"""Processed-AMISR reader with the reference's QC semantics.

``qc_datasets`` applies the reference reader's selection and QC
(interpolate.py:582-667) to any mapping from HDF5 paths to arrays: an open
h5py file, or the in-memory dict of ``io.synth.synthetic_amisr_datasets``.
``read_datafile`` opens a file with h5py and calls it.  ``beam_indices``
and ``beam_index`` give each point's beam number the same two ways.

* PARAM routing: 'dens' -> /FittedParams/{Ne,dNe}; otherwise
  '<quantity>_<species>' indexes /FittedParams/{Fits,Errors}[..., m, i]
  with i from {'frac':0,'temp':1,'colfreq':2} and m from the IonMass match
  (m = -1, i.e. electrons, when the species mass is absent).
* the chi2-369 legacy correction when nanmedian(chi2) > 100.
* QC masking: a point survives only if errlim[0] < error < errlim[1],
  chi2lim[0] < chi2 < chi2lim[1], and fitcode in goodfitcode; failures
  become NaN in value AND error.
* points whose (flattened) altitude coordinate is NaN are dropped.
"""

from __future__ import annotations

import numpy as np

INDEX_DICT = {"frac": 0, "temp": 1, "colfreq": 2}
MASS_DICT = {"O": 16, "O2": 32, "NO": 30, "N2": 28, "N": 14}


def qc_datasets(src, param, errlim, chi2lim, goodfitcode):
    """Returns (utime [nrec,2], lat [npts], lon, alt, value [nrec,npts],
    error [nrec,npts]) from a mapping of HDF5 paths to arrays."""
    utime = src["/Time/UnixTime"][:]
    alt = src["/Geomag/Altitude"][:]
    lat = src["/Geomag/Latitude"][:]
    lon = src["/Geomag/Longitude"][:]
    c2 = src["/FittedParams/FitInfo/chi2"][:]
    fc = src["/FittedParams/FitInfo/fitcode"][:]
    imass = src["/FittedParams/IonMass"][:]

    if param == "dens":
        val = src["/FittedParams/Ne"][:]
        err = src["/FittedParams/dNe"][:]
    else:
        p = param.split("_")
        i = INDEX_DICT[p[0]]
        try:
            m = int(np.where(imass == MASS_DICT[p[1]])[0][0])
        except IndexError:
            m = -1
        val = src["/FittedParams/Fits"][:, :, :, m, i]
        err = src["/FittedParams/Errors"][:, :, :, m, i]

    altitude = alt.flatten()
    latitude = lat.flatten()
    longitude = lon.flatten()
    chi2 = c2.reshape(c2.shape[0], -1)
    fitcode = fc.reshape(fc.shape[0], -1)
    value = val.reshape(val.shape[0], -1).astype(np.float64)
    error = err.reshape(err.shape[0], -1).astype(np.float64)

    # legacy chi2 overestimation correction (interpolate.py:645-646)
    if np.nanmedian(chi2) > 100.0:
        chi2 = chi2 - 369.0

    good = ((error > errlim[0]) & (error < errlim[1])
            & (chi2 > chi2lim[0]) & (chi2 < chi2lim[1])
            & np.isin(fitcode, goodfitcode))
    value[~good] = np.nan
    error[~good] = np.nan

    finite_coord = np.isfinite(altitude)
    value = value[:, finite_coord]
    error = error[:, finite_coord]
    latitude = latitude[finite_coord]
    longitude = longitude[finite_coord]
    altitude = altitude[finite_coord]

    return utime, latitude, longitude, altitude, value, error


def read_datafile(filename, param, errlim, chi2lim, goodfitcode):
    """``qc_datasets`` of a processed-AMISR HDF5 file."""
    import h5py

    with h5py.File(filename, "r") as f:
        return qc_datasets(f, param, errlim, chi2lim, goodfitcode)


def beam_indices(src):
    """Per-point beam index aligned with qc_datasets' point axis, from a
    mapping of HDF5 paths to arrays.  AMISR geometry arrays are [nbeam,
    nrange]; the reader flattens them and drops NaN-coordinate points, and
    the beam row index goes through the same flatten and filter (the
    leave-one-beam-out sweep, sweep.py, groups points by it)."""
    alt = np.asarray(src["/Geomag/Altitude"][:])
    nbeam, nrange = alt.shape
    idx = np.repeat(np.arange(nbeam), nrange)
    return idx[np.isfinite(alt.flatten())]


def beam_index(filename):
    """``beam_indices`` of a processed-AMISR HDF5 file."""
    import h5py

    with h5py.File(filename, "r") as f:
        return beam_indices(f)
