"""The fit operation: ``Interpolate.calc_coeffs`` over consecutive calls of
``records_per_call`` records of the synthetic days (``days`` of them, made
from the seed and taken in turn); an operation is a record.

The program's reader (``qc_datasets``) reads the benchmark's in-memory
datasets in place of a file, and no coefficient file is written.  The
check holds what the window produced to the plain reference two ways:
every record of every call by its own data (its chi2 recomputed from its
coefficients, and whether it has a fit at all), and ``check_samples``
records drawn from the seed against the reference's own search.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench.harness import ini_text, seconds_of
from portbench.reference import data as ref_data
from portbench.reference import fit as ref_fit
from portbench.reference import model as ref_model
from portbench.reference.scope import refuse_unmodelled

# what reference/fit.py reproduces: the exact chi2 = nu search with the
# 0th-order matrix, on the sphharmlag basis, of the reader's 'dens'
MODELLED = {
    "DEFAULT": {"PARAM": {"dens"}, "FILENAME": None, "OUTPUTFILENAME": None,
                "REGULARIZATION_LIST": {"0thorder"},
                "REGULARIZATION_METHOD": {"chi2"}, "ERRLIM": None,
                "GOODFITCODE": None, "CHI2LIM": None},
    "MODEL": {"NAME": {"sphharmlag"}, "MAXK": None, "MAXL": None,
              "CAP_LIM": None, "MAX_Z_INT": {"INF"}, "LATCP": None,
              "LONCP": None},
    "TPU": {"QUAD_MODE": None, "REGPARAM_MODE": {"exact"}},
}
REF_THREADS = 8  # records the reference fits at once


class Runner:
    rate = ("fit_records_per_s", "records/s")

    def __init__(self, cfg, traffic, device):
        refuse_unmodelled(cfg, MODELLED)
        from volumetricinterp_tpu_torch import Interpolate
        from volumetricinterp_tpu_torch.io.amisr import qc_datasets

        class BenchInterpolate(Interpolate):
            source = None

            def read_datafile(self, filename):
                return qc_datasets(self.source, self.param, self.errlim,
                                   self.chi2lim, self.goodfitcode)

        self.cfg, self.traffic = cfg, traffic
        self.day = cfg["day"]
        self.rpc = int(traffic["records_per_call"])
        self.work_per_op = 1
        self.calls_per_day = self.day["nrec"] // self.rpc
        if self.calls_per_day < 1:
            raise ValueError("records_per_call exceeds a day's records")
        self.interp = BenchInterpolate(ini_text(cfg), device=device)
        self.days = []
        self.results = {}  # window call -> (day, first record, C, chi2)

    def load(self, seed):
        """The seed's days (every seed the same sizes)."""
        U = ref_data.smooth_basis(self.day, self.cfg["MODEL"])
        self.results = {}
        self.days = [ref_data.make_day(self.day, self.cfg["MODEL"], seed, i,
                                       U=U)
                     for i in range(int(self.traffic["days"]))]

    def where(self, call):
        """(day index, first record) of a call."""
        d, k = divmod(call, self.calls_per_day)
        return d % len(self.days), k * self.rpc

    def call(self, i, keep=True):
        """Fit call i; returns its operations (records)."""
        d, s = self.where(i)
        src = self.days[d]
        ut = src["/Time/UnixTime"]
        self.interp.source = src
        self.interp.calc_coeffs(seconds_of(ut[s, 0]),
                                seconds_of(ut[s + self.rpc - 1, 1]))
        if keep:
            self.results[i] = (d, s, self.interp.Coeffs, self.interp.chi_sq)
        return self.rpc

    def failed(self):
        return int(sum(np.isnan(r[3]).sum() for r in self.results.values()))

    def timers(self):
        return [self.interp.timer]

    def release(self):
        """Drop the program's large state before the reference runs."""
        for k in ("Covariance", "Coeffs", "chi_sq", "reg_params"):
            setattr(self.interp, k, None)

    def check(self, rng, k, control=False):
        """The compared numbers.  Over every record of every window call:
        ``window_no_fit_mismatch`` and ``window_chi2_self_gap_max`` (see
        ``self_gaps``).  Over k records drawn from them (none when k is 0):
        each side's fit against the float64 reference's (with ``control``,
        the reference in float32 in the program's place, and the
        every-record numbers of its fits on those records)."""
        model = self.cfg["MODEL"]
        qcd = {}  # day -> (value, error) of the QC'd points
        A = None
        for d in sorted({r[0] for r in self.results.values()}):
            _, lat, lon, alt, value, error = ref_data.qc(self.days[d],
                                                         self.cfg["DEFAULT"])
            qcd[d] = (value, error)
            if A is None:  # the geometry is the configuration's
                A = ref_model.basis(model, lat, lon, alt)
        out = {}
        if not control:
            v, e, C, c2 = (np.concatenate(x) for x in zip(*(
                (qcd[d][0][s:s + self.rpc], qcd[d][1][s:s + self.rpc], C,
                 c2) for d, s, C, c2 in self.results.values())))
            out.update(self_gaps(A, v, e, C, c2))
        pairs = [(i, r) for i in sorted(self.results)
                 for r in range(self.rpc)]
        pick = sorted(rng.choice(len(pairs), size=min(k, len(pairs)),
                                 replace=False)) if k else []
        if not pick:
            return out
        R = ref_model.psi(model)
        jobs = []
        for j in pick:
            i, r = pairs[j]
            d, s, C_all, c2_all = self.results[i]
            value, error = qcd[d]
            jobs.append((value[s + r], error[s + r], C_all[r], c2_all[r]))

        def one(job):
            v, e, C, c2 = job
            C_ref, c2_ref, _ = ref_fit.fit_record(v, e, A, R)
            if control:
                C, c2, _ = ref_fit.fit_record(v, e, A, R, np.float32)
            return fit_gaps(A, v, e, C, c2, C_ref, c2_ref) + (C, c2)

        # the records' searches side by side: each is a chain of host eighs
        with ThreadPoolExecutor(min(REF_THREADS, len(jobs))) as pool:
            res = list(pool.map(one, jobs))
        gaps, chi2_gaps, one_side, C, c2 = zip(*res)
        if control:
            out.update(self_gaps(A, np.stack([j[0] for j in jobs]),
                                 np.stack([j[1] for j in jobs]),
                                 np.stack(C), np.array(c2)))
        out.update({"fit_field_gap_median": float(np.median(gaps)),
                    "fit_field_gap_max": float(np.max(gaps)),
                    "fit_chi2_gap_median": float(np.median(chi2_gaps)),
                    "fit_chi2_gap_max": float(np.max(chi2_gaps)),
                    "fit_nan_records": float(np.sum(one_side)),
                    "fit_records_checked": float(len(pick))})
        return out


def self_gaps(A, value, error, C, chi2):
    """Each record held to its own data (value, error [records, points];
    C [records, nbasis]; chi2 [records]): ``window_no_fit_mismatch``, the
    records that have valid points and no fit (a NaN chi2 or coefficient)
    or a fit and no valid point; ``window_chi2_self_gap_max``, over the
    records with both, the widest |chi2(C) - chi2| as a share of the
    record's sum of (value / error)^2 (the chi2 of no fit, the scale of
    the sums whose difference a chi2 is), chi2(C) the sum of ((A C -
    value) / error)^2 over the record's valid points."""
    ok = np.isfinite(value)
    has = ok.any(axis=1)
    fitted = np.isfinite(chi2) & np.isfinite(C).all(axis=1)
    both = has & fitted
    gap = 0.0
    if both.any():
        sw = np.where(ok[both], 1.0 / np.where(ok[both], error[both], 1.0),
                      0.0)
        b = sw * np.where(ok[both], value[both], 0.0)
        r = sw * (C[both] @ A.T) - b
        g = (np.abs(np.sum(r * r, axis=1) - chi2[both])
             / np.sum(b * b, axis=1))
        gap = float(np.max(np.where(np.isnan(g), np.inf, g)))
    return {"window_no_fit_mismatch": float(np.sum(has != fitted)),
            "window_chi2_self_gap_max": gap}


def fit_gaps(A, value, error, C, chi2, C_ref, chi2_ref):
    """(field gap, chi2 gap, 1 if exactly one side has no fit) of one
    record.  The field gap is the W-weighted field residual |sw A (C -
    C_ref)| / |sw A C_ref| over the record's valid points (sw = 1/error);
    the chi2 gap |chi2 - chi2_ref| / chi2_ref.  A side with no fit (NaN)
    reads as a zero field and a zero chi2: gap 1 against a fit, 0 where
    neither has one."""
    ok_p, ok_r = bool(np.isfinite(chi2)), bool(np.isfinite(chi2_ref))
    if not (ok_p or ok_r):
        return 0.0, 0.0, 0
    if ok_p != ok_r:
        return 1.0, 1.0, 1
    pts = np.isfinite(value)
    sw = 1.0 / error[pts]
    ref = sw * (A[pts] @ C_ref)
    gap = np.linalg.norm(sw * (A[pts] @ C) - ref) / np.linalg.norm(ref)
    return float(gap), float(abs(chi2 - chi2_ref) / chi2_ref), 0
