"""Coefficient-file writer/reader, reference HDF5 schema.

Copy of ``volumetricinterp_tpu/io/coeffs.py`` with the same file schema,
so coefficient files interchange both ways between the two packages; h5py
is imported inside the functions.

Schema parity with interpolate.py:671-708 / estimate.py:53-70:

    /UnixTime                 [nrec, 2]
    /Coeffs/C                 [nrec, nbasis]
    /Coeffs/dC                [nrec, nbasis, nbasis]
    /FitParams/reglist        [nreg] bytes
    /FitParams/regmethod      bytes scalar
    /FitParams/chi2           [nrec]
    /FitParams/hull_vert      [nvert, 3] ECEF metres
    /RawData/filename         bytes scalar
    /ConfigFile/{Name,Path,Contents}   bytes scalars

The embedded config text makes the file self-describing: Estimate re-parses
it to reconstruct the identical Model (estimate.py:41-50), a round trip this
module preserves verbatim.  Files written by the reference (pytables) read
fine through h5py and vice versa.

Extensions beyond the reference (backwards-compatible additions):
    /FitParams/reg_params     [nrec, nreg]  the selected alpha values
    /TimeFit/{knots,S,lam}    time-spline payload (ops/timesmooth.py),
                              when [DEFAULT] TIME_SMOOTHING is set
    incremental chunk flushing for long runs (checkpoint/resume,
    SURVEY.md section 5.3-5.4).
"""

from __future__ import annotations

import os

import numpy as np


def save_coeff_file(
    filename,
    utime,
    coeffs,
    covariance,
    chi2,
    hull_vert,
    reg_list,
    reg_method,
    raw_filename,
    config_name,
    config_path,
    config_contents,
    reg_params=None,
    timefit=None,
):
    import h5py

    with h5py.File(filename, "w") as f:
        f.create_dataset("UnixTime", data=np.asarray(utime))
        cg = f.create_group("Coeffs")
        cg.create_dataset("C", data=np.asarray(coeffs))
        cg.create_dataset("dC", data=np.asarray(covariance))
        fg = f.create_group("FitParams")
        fg.create_dataset(
            "reglist", data=np.array([r.encode("utf-8") for r in reg_list])
        )
        fg.create_dataset("regmethod", data=np.bytes_(reg_method.encode("utf-8")))
        fg.create_dataset("chi2", data=np.asarray(chi2))
        fg.create_dataset("hull_vert", data=np.asarray(hull_vert))
        if reg_params is not None:
            fg.create_dataset("reg_params", data=np.asarray(reg_params))
        dg = f.create_group("RawData")
        dg.create_dataset("filename", data=np.bytes_(raw_filename.encode("utf-8")))
        gg = f.create_group("ConfigFile")
        gg.create_dataset("Name", data=np.bytes_(config_name.encode("utf-8")))
        gg.create_dataset("Path", data=np.bytes_(config_path.encode("utf-8")))
        gg.create_dataset("Contents", data=np.bytes_(config_contents.encode("utf-8")))
        if timefit is not None:
            tg = f.create_group("TimeFit")
            tg.create_dataset("knots", data=np.asarray(timefit["knots"]))
            tg.create_dataset("S", data=np.asarray(timefit["S"]))
            tg.create_dataset("lam", data=np.float64(timefit["lam"]))


def load_coeff_file(filename):
    """Returns a dict with the schema fields (bytes decoded where scalar)."""
    import h5py

    out = {}
    with h5py.File(filename, "r") as f:
        out["Coeffs"] = f["/Coeffs/C"][:]
        out["Covariance"] = f["/Coeffs/dC"][:]
        out["UnixTime"] = f["/UnixTime"][:]
        out["hull_vert"] = f["/FitParams/hull_vert"][:]
        out["chi2"] = f["/FitParams/chi2"][:]
        out["reglist"] = [
            r.decode("utf-8") if isinstance(r, bytes) else str(r)
            for r in f["/FitParams/reglist"][:]
        ]
        rm = f["/FitParams/regmethod"][()]
        out["regmethod"] = rm.decode("utf-8") if isinstance(rm, bytes) else str(rm)
        out["config_file_text"] = f["/ConfigFile/Contents"][()]
        rf = f["/RawData/filename"][()]
        out["raw_filename"] = rf.decode("utf-8") if isinstance(rf, bytes) else str(rf)
        if "reg_params" in f["/FitParams"]:
            out["reg_params"] = f["/FitParams/reg_params"][:]
        if "TimeFit" in f:
            out["timefit"] = {
                "knots": f["/TimeFit/knots"][:],
                "S": f["/TimeFit/S"][:],
                "lam": float(f["/TimeFit/lam"][()]),
            }
    return out


class IncrementalCoeffWriter:
    """Chunked coefficient writer for checkpoint/resume of long fits.

    The reference writes everything once at the end (interpolate.py:671-708);
    a killed multi-hour batch job loses all records.  This writer flushes
    per record-chunk into resizable datasets with an /nrec_done counter, so a
    restarted run resumes at the last completed chunk (SURVEY.md section
    5.3-5.4).  On close() the file contents equal save_coeff_file's output
    plus the counter.
    """

    def __init__(self, filename, nrec, nbasis, meta, fresh=False):
        """fresh=True recreates the file unconditionally (non-resume runs:
        stale metadata from a previous run with the same shapes must not
        survive); fresh=False keeps a shape-compatible checkpoint for
        resume."""
        import h5py

        self.filename = filename
        self.nrec = nrec
        mode = "w" if fresh or not os.path.exists(filename) else "r+"
        self.f = h5py.File(filename, mode)
        if "Coeffs" in self.f:
            # a pre-existing file is resumable only if it was written by
            # this writer FOR THE SAME RUN SHAPE: a file from
            # save_coeff_file (no /nrec_done), or from a run with a
            # different record count / basis size, would otherwise resume
            # with misaligned chunk offsets or KeyError later
            resumable = (
                "nrec_done" in self.f
                and self.f["Coeffs/C"].shape == (nrec, nbasis)
                and self.f["UnixTime"].shape == (nrec, 2)
            )
            if not resumable:
                self.f.close()
                self.f = h5py.File(filename, "w")
        if "Coeffs" not in self.f:
            self.f.create_dataset("UnixTime", shape=(nrec, 2), dtype="f8")
            cg = self.f.create_group("Coeffs")
            cg.create_dataset("C", shape=(nrec, nbasis), dtype="f8")
            cg.create_dataset("dC", shape=(nrec, nbasis, nbasis), dtype="f8")
            fg = self.f.create_group("FitParams")
            fg.create_dataset("chi2", shape=(nrec,), dtype="f8")
            fg.create_dataset(
                "reglist",
                data=np.array([r.encode("utf-8") for r in meta["reg_list"]])
                if meta["reg_list"]
                else np.zeros((0,), dtype="S1"),
            )
            fg.create_dataset(
                "regmethod", data=np.bytes_(meta["reg_method"].encode("utf-8"))
            )
            fg.create_dataset("hull_vert", data=np.asarray(meta["hull_vert"]))
            nregs = len(meta["reg_list"])
            fg.create_dataset("reg_params", shape=(nrec, nregs), dtype="f8")
            dg = self.f.create_group("RawData")
            dg.create_dataset(
                "filename", data=np.bytes_(meta["raw_filename"].encode("utf-8"))
            )
            gg = self.f.create_group("ConfigFile")
            gg.create_dataset("Name", data=np.bytes_(meta["config_name"].encode("utf-8")))
            gg.create_dataset("Path", data=np.bytes_(meta["config_path"].encode("utf-8")))
            gg.create_dataset(
                "Contents", data=np.bytes_(meta["config_contents"].encode("utf-8"))
            )
            self.f.create_dataset("nrec_done", data=np.int64(0))

    @property
    def nrec_done(self) -> int:
        return int(self.f["nrec_done"][()])

    def write_chunk(self, start, utime, C, dC, chi2, reg_params):
        end = start + C.shape[0]
        self.f["UnixTime"][start:end] = np.asarray(utime)
        self.f["Coeffs/C"][start:end] = np.asarray(C)
        self.f["Coeffs/dC"][start:end] = np.asarray(dC)
        self.f["FitParams/chi2"][start:end] = np.asarray(chi2)
        if reg_params is not None and reg_params.shape[-1] > 0:
            self.f["FitParams/reg_params"][start:end] = np.asarray(reg_params)
        self.f["nrec_done"][()] = np.int64(end)
        self.f.flush()

    def close(self):
        self.f.close()


def finalize_checkpoint(filename, timefit=None):
    """Convert a COMPLETED IncrementalCoeffWriter file into
    save_coeff_file's exact schema IN PLACE: drop the /nrec_done counter
    and add the optional /TimeFit payload.  The heavy datasets (166 MB of
    dC for a 1000-record day) were already flushed chunk by chunk during
    the fit, so finalizing costs metadata-only I/O
    instead of a full rewrite."""
    import h5py

    with h5py.File(filename, "r+") as f:
        if "nrec_done" in f:
            del f["nrec_done"]
        if timefit is not None and "TimeFit" not in f:
            tg = f.create_group("TimeFit")
            tg.create_dataset("knots", data=np.asarray(timefit["knots"]))
            tg.create_dataset("S", data=np.asarray(timefit["S"]))
            tg.create_dataset("lam", data=np.float64(timefit["lam"]))
