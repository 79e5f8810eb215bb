"""Validate — fit a time window and render reconstruction-vs-data maps
(API parity with the reference validate.py:16-132 and the JAX package's
Validate).

The fit and the evaluation run on ``device`` through Interpolate and
Estimate; the maps are drawn on the host.  matplotlib (Agg backend, so it
runs headless) and the optional cartopy are imported inside create_plots:
without cartopy the panels are plain lat/lon axes with the same contour and
scatter content.
"""

from __future__ import annotations

import datetime as dt

import numpy as np

from .config import Config
from .interpolate import Interpolate
from .estimate import Estimate
from . import coords


class Validate:
    def __init__(self, config_file, device="cuda"):
        """config_file: a Config, a path, an open file or INI text.
        device: where the fit and the evaluation run ('cuda' or 'cpu')."""
        self.device = device
        if isinstance(config_file, Config):
            self.config = config_file
            self.configfile = self.config.path or ""
        else:
            self.configfile = config_file if isinstance(config_file, str) else ""
            self.config = Config.from_file(config_file)
        self.read_config(self.config)

    def read_config(self, config):
        """[VALIDATE] section (reference validate.py:32-51)."""
        if not isinstance(config, Config):
            config = Config.from_file(config)
            self.config = config
        v = config.validate
        self.starttime = v.starttime
        self.endtime = v.endtime
        self.altitudes = list(v.altitudes)
        self.colorlim = list(v.colorlim)
        self.outputpng = v.outpngname

    def interpolate(self):
        """Windowed fit with the standard engine (reference validate.py:53-61)."""
        interp = Interpolate(self.config, device=self.device)
        interp.calc_coeffs(starttime=self.starttime, endtime=self.endtime)
        interp.saveh5()
        self.outputfilename = interp.outputfilename

    def _load_window(self):
        """Evaluation grid + the raw measurements inside the validation
        window.  Returns (est, grid (lat, lon, alt), times, raw arrays)."""
        import h5py

        est_param = Estimate(self.outputfilename, device=self.device)

        hull_lat, hull_lon, _ = coords.ecef2geodetic(
            est_param.hull_vert[:, 0], est_param.hull_vert[:, 1],
            est_param.hull_vert[:, 2])
        gdlat, gdlon, gdalt = np.meshgrid(
            np.linspace(np.nanmin(hull_lat), np.nanmax(hull_lat), 100),
            np.linspace(np.nanmin(hull_lon), np.nanmax(hull_lon), 100),
            np.array(self.altitudes) * 1000.0,
        )

        with h5py.File(self.outputfilename, "r") as f:
            raw_filename = f["/RawData/filename"][()]
        if isinstance(raw_filename, bytes):
            raw_filename = raw_filename.decode("utf-8")

        epoch = dt.datetime(1970, 1, 1)
        with h5py.File(raw_filename, "r") as f:
            raw_alt = f["/Geomag/Altitude"][:]
            raw_lat = f["/Geomag/Latitude"][:]
            raw_lon = f["/Geomag/Longitude"][:]
            utime = f["Time/UnixTime"][:]
            idx = np.argwhere(
                (utime[:, 0] >= (self.starttime - epoch).total_seconds())
                & (utime[:, 1] <= (self.endtime - epoch).total_seconds())
            ).flatten()
            raw_time = np.array(
                [epoch + dt.timedelta(seconds=float(t))
                 for t in np.mean(utime, axis=1)[idx]]
            )
            raw_dens = f["FittedParams/Ne"][idx, :, :]
        return est_param, (gdlat, gdlon, gdalt), raw_time, (
            raw_lat, raw_lon, raw_alt, raw_dens)

    def create_plots(self):
        """Render one map panel per (record, altitude): filled contours of
        the reconstruction with the raw beam measurements scattered on top
        in the same color scale (the reference workflow's product,
        validate.py:64-132; panel content kept, layout our own).

        cartopy gives Lambert-conformal map panels when importable; plain
        lat/lon axes otherwise."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        try:
            import cartopy.crs as ccrs

            have_cartopy = True
        except ImportError:
            have_cartopy = False

        est_param, (gdlat, gdlon, gdalt), raw_time, raw = self._load_window()
        raw_lat, raw_lon, raw_alt, raw_dens = raw
        # one longitude convention for grid and scatter: the hull-derived
        # grid is +-180 (ecef2geodetic) while AMISR files store 0..360 —
        # without cartopy's Geodetic transform the two would plot 360 deg
        # apart on plain axes
        raw_lon = np.where(raw_lon > 180.0, raw_lon - 360.0, raw_lon)
        gdlon = np.where(gdlon > 180.0, gdlon - 360.0, gdlon)

        nrow = len(raw_time)
        ncol = len(self.altitudes)
        vmin, vmax = self.colorlim
        levels = np.linspace(vmin, vmax, 25)

        subplot_kw = {}
        if have_cartopy:
            subplot_kw["projection"] = ccrs.LambertConformal(
                central_latitude=float(np.nanmean(gdlat)),
                central_longitude=float(np.nanmean(gdlon)),
            )
        fig, axes = plt.subplots(
            nrow, ncol, squeeze=False, subplot_kw=subplot_kw,
            figsize=(2.4 * ncol + 1.2, 2.4 * nrow + 1.0), dpi=110,
            layout="constrained",
        )
        fig.suptitle(
            f"{self.starttime:%Y-%m-%d %H:%M} – {self.endtime:%H:%M} UT",
            fontsize="medium",
        )

        mappable = None
        beam_rows = np.arange(raw_alt.shape[0])
        for i, time in enumerate(raw_time):
            dens = est_param(time, gdlat, gdlon, gdalt)
            for j, alt in enumerate(self.altitudes):
                ax = axes[i, j]
                # nearest range gate to this altitude slice, per beam
                gate = np.nanargmin(np.abs(raw_alt - alt * 1000.0), axis=1)
                rlat = raw_lat[beam_rows, gate]
                rlon = raw_lon[beam_rows, gate]
                rval = raw_dens[i][beam_rows, gate]

                if have_cartopy:
                    ax.coastlines(lw=0.5)
                    ax.gridlines(lw=0.3, alpha=0.5)
                    grid_kw = dict(transform=ccrs.PlateCarree())
                else:
                    grid_kw = {}
                    ax.tick_params(labelsize="x-small")

                mappable = ax.contourf(
                    gdlon[:, :, j], gdlat[:, :, j], dens[:, :, j],
                    levels, cmap="viridis", extend="both", **grid_kw,
                )
                # raw beam data in the same color scale, ringed so the dots
                # stay visible against equal-valued background
                ax.scatter(
                    rlon, rlat, c=rval, s=14, vmin=vmin, vmax=vmax,
                    cmap="viridis", edgecolors="white", linewidths=0.6,
                    **grid_kw,
                )
                if i == 0:
                    ax.set_title(f"{alt:g} km", fontsize="small")
            axes[i, 0].set_ylabel(
                f"{time:%H:%M:%S}", fontsize="small", labelpad=18,
            )
            if have_cartopy:
                # cartopy GeoAxes drop ylabels; annotate the row instead
                axes[i, 0].text(
                    -0.12, 0.5, f"{time:%H:%M:%S}", rotation=90,
                    va="center", ha="right", fontsize="small",
                    transform=axes[i, 0].transAxes,
                )

        if mappable is not None:
            cbar = fig.colorbar(
                mappable, ax=axes[-1, :], location="bottom",
                shrink=0.55, aspect=35, pad=0.04,
            )
            cbar.set_label(r"N$_e$ (m$^{-3}$)", fontsize="small")

        fig.savefig(self.outputpng)
        plt.close(fig)
