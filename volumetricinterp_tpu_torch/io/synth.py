"""Synthetic processed-AMISR data (tests, benchmarks, the chip smoke run).

``synthetic_amisr_datasets`` builds the datasets of a processed-AMISR file
in memory, keyed by their HDF5 paths: /Time/UnixTime,
/Geomag/{Altitude,Latitude,Longitude}, /FittedParams/{Ne,dNe,Fits,Errors,
IonMass}, /FittedParams/FitInfo/{chi2,fitcode}.  The electron density
follows a Chapman layer over a beam geometry, with controllable NaN
dropouts, QC-failing points and the optional chi2+369 legacy offset.
``write_synthetic_amisr`` writes those datasets to a file.

The random draws come from ``np.random.default_rng(seed)`` in the same
order as the JAX package's generator (volumetricinterp_tpu/io/synth.py), so
both packages produce the same day from the same seed, bit for bit.
"""

from __future__ import annotations

import numpy as np


def chapman_ne(alt, nmax=4.0e11, hmax=300.0e3, hscale=60.0e3):
    zz = (alt - hmax) / hscale
    return nmax * np.exp(0.5 * (1.0 - zz - np.exp(-zz)))


def beam_grid_geometry(
    site_lat=74.72955,
    site_lon=265.09424,
    n_az=5,
    n_el=4,
    n_range=30,
    range_min=150.0e3,
    range_max=800.0e3,
):
    """Simple straight-line beam propagation in a local tangent frame.

    Returns (lat [nbeam, nrange], lon, alt) -- 2-D arrays matching the
    beam x range layout of real files.
    """
    az = np.linspace(0.0, 2.0 * np.pi, n_az, endpoint=False)
    el = np.deg2rad(np.linspace(50.0, 85.0, n_el))
    ranges = np.linspace(range_min, range_max, n_range)
    lats, lons, alts = [], [], []
    for a in az:
        for e in el:
            horiz = ranges * np.cos(e)
            alt = ranges * np.sin(e)
            dlat = horiz * np.cos(a) / 111.2e3
            dlon = horiz * np.sin(a) / (111.2e3 * np.cos(np.deg2rad(site_lat)))
            lats.append(site_lat + dlat)
            lons.append(site_lon + dlon)
            alts.append(alt)
    return np.array(lats), np.array(lons), np.array(alts)


def synthetic_amisr_datasets(
    nrec=10,
    t0=1480286700.0,
    cadence=60.0,
    seed=0,
    nan_frac=0.05,
    bad_frac=0.03,
    chi2_offset=False,
    nan_coord_rows=1,
    geometry=None,
    smooth_in_model=None,
):
    """Datasets of a synthetic file, {hdf5 path: array}.

    smooth_in_model: optional Model whose basis span the truth is projected
    onto (makes chi2=nu satisfiable for fit tests).
    """
    rng = np.random.default_rng(seed)
    if geometry is None:
        lat2, lon2, alt2 = beam_grid_geometry()
    else:
        lat2, lon2, alt2 = geometry
    nbeam, nrange = lat2.shape

    if nan_coord_rows:
        # some range gates have undefined coordinates, like real files
        alt2 = alt2.copy()
        alt2[:, :nan_coord_rows] = np.nan

    utime = np.stack(
        [t0 + cadence * np.arange(nrec), t0 + cadence * (np.arange(nrec) + 1)],
        axis=-1,
    )

    flat_alt = alt2.flatten()
    if smooth_in_model is not None:
        A = np.asarray(
            smooth_in_model.basis(
                np.where(np.isfinite(flat_alt), lat2.flatten(), 74.0),
                np.where(np.isfinite(flat_alt), lon2.flatten(), 265.0),
                np.where(np.isfinite(flat_alt), flat_alt, 300e3),
            )
        )

    ne = np.zeros((nrec, nbeam, nrange))
    dne = np.zeros_like(ne)
    for r in range(nrec):
        mod = 1.0 + 0.15 * np.sin(np.deg2rad(lon2 - 262.0) * 6.0 + 0.3 * r)
        truth = (chapman_ne(np.where(np.isfinite(alt2), alt2, 300e3)) * mod)
        if smooth_in_model is not None:
            tgt = truth.flatten()
            Ct = np.linalg.lstsq(A, tgt, rcond=1e-10)[0]
            truth = (A @ Ct).reshape(truth.shape)
        noise = 2e10 + 0.05 * np.abs(truth)
        ne[r] = truth + rng.normal(0.0, 1.0, truth.shape) * noise
        dne[r] = 1.15 * noise

    # QC fields
    chi2 = rng.uniform(0.5, 3.0, (nrec, nbeam, nrange))
    fitcode = rng.choice([1, 2, 3], size=(nrec, nbeam, nrange)).astype(np.int32)

    # inject QC failures: huge errors, bad chi2, bad fitcodes, NaN values
    for frac, arr, bad in ((bad_frac / 3, dne, 1e14), (bad_frac / 3, chi2, 120.0),
                           (bad_frac / 3, fitcode, 7), (nan_frac, ne, np.nan)):
        arr[rng.random((nrec, nbeam, nrange)) < frac] = bad

    if chi2_offset:
        chi2 = chi2 + 369.0

    # Fits/Errors arrays: [nrec, nbeam, nrange, nion+1, 4], [..., m, i] with
    # i in {frac:0, temp:1, colfreq:2}; the last ion index is electrons
    nion = 2
    imass = np.array([16, 30], dtype=np.int32)
    fits = np.full((nrec, nbeam, nrange, nion + 1, 4), np.nan)
    errs = np.full_like(fits, np.nan)
    fits[..., 0, 0] = 0.9  # frac_O
    errs[..., 0, 0] = 0.05
    fits[..., -1, 1] = 2000.0 + rng.normal(0, 50, (nrec, nbeam, nrange))  # temp_e
    errs[..., -1, 1] = 100.0

    return {
        "/Time/UnixTime": utime,
        "/Geomag/Altitude": alt2,
        "/Geomag/Latitude": lat2,
        "/Geomag/Longitude": lon2,
        "/FittedParams/Ne": ne,
        "/FittedParams/dNe": dne,
        "/FittedParams/Fits": fits,
        "/FittedParams/Errors": errs,
        "/FittedParams/IonMass": imass,
        "/FittedParams/FitInfo/chi2": chi2,
        "/FittedParams/FitInfo/fitcode": fitcode,
    }


def write_synthetic_amisr(filename, **kwargs):
    """Write a synthetic file (keyword arguments as for
    ``synthetic_amisr_datasets``); returns (lat, lon, alt, values)."""
    import h5py

    d = synthetic_amisr_datasets(**kwargs)
    with h5py.File(filename, "w") as f:
        for path, arr in d.items():
            f.create_dataset(path, data=arr)
    return (d["/Geomag/Latitude"], d["/Geomag/Longitude"],
            d["/Geomag/Altitude"], d["/FittedParams/Ne"])
