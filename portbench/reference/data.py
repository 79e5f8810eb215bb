"""The benchmark's inputs, made from a seed: synthetic processed-AMISR days,
their QC, the FoV hull and the product grid.

A frozen copy of the generator the port's tests use (beam geometry, Chapman
truth projected onto a smooth basis, noise, NaN dropouts and QC failures)
and of the reference reader's QC rules, in NumPy and SciPy alone.  It
imports nothing of the program: both the program and the plain reference
take their inputs from here.
"""

from __future__ import annotations

import numpy as np

from .model import basis, geodetic2ecef

# the processed-AMISR datasets the program's reader takes, by HDF5 path
PATHS = ("/Time/UnixTime", "/Geomag/Altitude", "/Geomag/Latitude",
         "/Geomag/Longitude", "/FittedParams/Ne", "/FittedParams/dNe",
         "/FittedParams/Fits", "/FittedParams/Errors",
         "/FittedParams/IonMass", "/FittedParams/FitInfo/chi2",
         "/FittedParams/FitInfo/fitcode")


def chapman_ne(alt, nmax=4.0e11, hmax=300.0e3, hscale=60.0e3):
    zz = (alt - hmax) / hscale
    return nmax * np.exp(0.5 * (1.0 - zz - np.exp(-zz)))


def beam_geometry(day):
    """Straight beams in a local tangent frame about the site: (lat, lon,
    alt), each [nbeam, nrange]; the first ``nan_coord_rows`` gates of every
    beam have no altitude, as in real files."""
    az = np.linspace(0.0, 2.0 * np.pi, day["n_az"], endpoint=False)
    el = np.deg2rad(np.linspace(50.0, 85.0, day["n_el"]))
    ranges = np.linspace(day["range_min"], day["range_max"], day["n_range"])
    a, e = np.meshgrid(az, el, indexing="ij")
    a, e = a.reshape(-1, 1), e.reshape(-1, 1)
    horiz, alt = ranges * np.cos(e), ranges * np.sin(e)
    lat = day["site_lat"] + horiz * np.cos(a) / 111.2e3
    lon = day["site_lon"] + horiz * np.sin(a) / (
        111.2e3 * np.cos(np.deg2rad(day["site_lat"])))
    alt = alt.copy()
    alt[:, :day["nan_coord_rows"]] = np.nan
    return lat, lon, alt


def smooth_basis(day, model):
    """An orthonormal basis [gates, rank] of the span the truth is
    projected onto: ``model`` at the orders of ``day["smooth_in"]``, at
    every gate (gates without altitude at a placeholder point), its
    singular directions above 1e-10 of the largest (lstsq's rcond)."""
    lat, lon, alt = beam_geometry(day)
    ok = np.isfinite(alt)
    sm = dict(model, **day["smooth_in"])
    B = basis(sm, np.where(ok, lat, 74.0).ravel(),
              np.where(ok, lon, 265.0).ravel(),
              np.where(ok, alt, 300e3).ravel())
    U, s, _ = np.linalg.svd(B, full_matrices=False)
    return U[:, s > 1e-10 * s[0]]


def make_day(day, model, seed, index=0, U=None):
    """One day of ``day["nrec"]`` records, {HDF5 path: array}, drawn from
    (seed, index).  ``U``: smooth_basis(day, model), when the caller has
    it."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed),
                                                        int(index)]))
    nrec = day["nrec"]
    lat, lon, alt = beam_geometry(day)
    nbeam, nrange = lat.shape
    t0 = day["t0"] + index * nrec * day["cadence_s"]
    start = t0 + day["cadence_s"] * np.arange(nrec)
    utime = np.stack([start, start + day["cadence_s"]], axis=-1)

    if U is None:
        U = smooth_basis(day, model)
    r = np.arange(nrec)[:, None, None]
    mod = 1.0 + 0.15 * np.sin(np.deg2rad(lon - 262.0) * 6.0 + 0.3 * r)
    truth = chapman_ne(np.where(np.isfinite(alt), alt, 300e3)) * mod
    flat = truth.reshape(nrec, -1).T
    truth = (U @ (U.T @ flat)).T.reshape(nrec, nbeam, nrange)
    noise = 2e10 + 0.05 * np.abs(truth)
    ne = truth + rng.normal(0.0, 1.0, truth.shape) * noise
    dne = 1.15 * noise

    shape = (nrec, nbeam, nrange)
    chi2 = rng.uniform(0.5, 3.0, shape)
    fitcode = rng.choice([1, 2, 3], size=shape).astype(np.int32)
    bad = day["bad_frac"] / 3
    for frac, arr, val in ((bad, dne, 1e14), (bad, chi2, 120.0),
                           (bad, fitcode, 7), (day["nan_frac"], ne, np.nan)):
        arr[rng.random(shape) < frac] = val

    nion = 2
    fits = np.full(shape + (nion + 1, 4), np.nan)
    errs = np.full_like(fits, np.nan)
    fits[..., 0, 0], errs[..., 0, 0] = 0.9, 0.05
    fits[..., -1, 1] = 2000.0 + rng.normal(0.0, 50.0, shape)
    errs[..., -1, 1] = 100.0
    return dict(zip(PATHS, (utime, alt, lat, lon, ne, dne, fits, errs,
                            np.array([16, 30], dtype=np.int32), chi2,
                            fitcode)))


def qc(src, fit):
    """The reference reader's selection and QC of the 'dens' parameter:
    (utime, lat, lon, alt, value [nrec, npts], error): a point survives
    only inside ERRLIM, CHI2LIM and GOODFITCODE (failures NaN in value and
    error); gates without altitude are dropped."""
    if fit["PARAM"] != "dens":
        raise ValueError(f"the frozen reader knows PARAM = dens only, not "
                         f"{fit['PARAM']!r}")
    alt = src["/Geomag/Altitude"].ravel()
    nrec = src["/FittedParams/Ne"].shape[0]
    value = src["/FittedParams/Ne"].reshape(nrec, -1).astype(np.float64)
    error = src["/FittedParams/dNe"].reshape(nrec, -1).astype(np.float64)
    chi2 = src["/FittedParams/FitInfo/chi2"].reshape(nrec, -1)
    code = src["/FittedParams/FitInfo/fitcode"].reshape(nrec, -1)
    if np.nanmedian(chi2) > 100.0:  # the legacy chi2 offset
        chi2 = chi2 - 369.0
    (e0, e1), (c0, c1) = fit["ERRLIM"], fit["CHI2LIM"]
    good = ((error > e0) & (error < e1) & (chi2 > c0) & (chi2 < c1)
            & np.isin(code, fit["GOODFITCODE"]))
    value[~good] = np.nan
    error[~good] = np.nan
    ok = np.isfinite(alt)
    return (src["/Time/UnixTime"], src["/Geomag/Latitude"].ravel()[ok],
            src["/Geomag/Longitude"].ravel()[ok], alt[ok], value[:, ok],
            error[:, ok])


def hull_vertices(lat, lon, alt):
    """ECEF vertices of the convex hull of the data points (the FoV that
    the fit stores beside its coefficients)."""
    from scipy.spatial import ConvexHull

    P = np.stack(geodetic2ecef(lat, lon, alt), axis=-1)
    return P[ConvexHull(P).vertices]


def product_grid(g):
    """The product grid of a traffic's ``grid``: (lat, lon, alt), each
    [nlat, nlon, nalt] (np.meshgrid's default order, lat varying along the
    second axis)."""
    return np.meshgrid(np.linspace(*g["lat"], g["nlat"]),
                       np.linspace(*g["lon"], g["nlon"]),
                       np.linspace(*g["alt"], g["nalt"]))
