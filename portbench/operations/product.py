"""The product operation: ``Estimate.evaluate_records`` of
``records_per_request`` consecutive records (walking the first
``coeff_records`` records of the day in turn) on the product ``grid`` (a
lat/lon/alt box) with the FoV hull mask; an operation is a request, its
work grid points x records.

The coefficients are the benchmark's own: a float64 regularized
least-squares fit of each record at the fixed ``coeff_log10_alpha`` on
the reference basis, held in memory (the Estimate's loadh5 takes them in
place of a file).  The check holds ``check_requests`` requests of the
window, a reservoir sample drawn from the seed, to the reference's hull
test at every grid point and to its field at ``check_samples`` FoV points.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import ini_text, seconds_of
from portbench.reference import data as ref_data
from portbench.reference import fit as ref_fit
from portbench.reference import model as ref_model
from portbench.reference import product as ref_product
from portbench.reference.scope import refuse_unmodelled

# what the product's reference reproduces: the sphharmlag field of given
# coefficients and the hull test; the fit's keys are read by no one here
MODELLED = {
    "DEFAULT": {"PARAM": {"dens"}, "FILENAME": None, "OUTPUTFILENAME": None,
                "REGULARIZATION_LIST": None, "REGULARIZATION_METHOD": None,
                "ERRLIM": None, "GOODFITCODE": None, "CHI2LIM": None},
    "MODEL": {"NAME": {"sphharmlag"}, "MAXK": None, "MAXL": None,
              "CAP_LIM": None, "MAX_Z_INT": {"INF"}, "LATCP": None,
              "LONCP": None},
    "TPU": {"QUAD_MODE": None, "REGPARAM_MODE": None},
}


class Runner:
    rate = ("product_point_records_per_s", "point-records/s")

    def __init__(self, cfg, traffic, device):
        refuse_unmodelled(cfg, MODELLED)
        from volumetricinterp_tpu_torch import Estimate

        class BenchEstimate(Estimate):
            inputs = None

            def loadh5(self, filename=None):
                d = self.inputs
                self.Coeffs, self.Covariance = d["C"], d["dC"]
                self.time, self.hull_vert = d["utime"], d["hull_vert"]
                self.config_file_text = d["ini"]
                self.chi2, self.raw_filename, self.timefit = None, "", None

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.cls = BenchEstimate
        self.est = None
        self.nrec = int(traffic["records_per_request"])
        self.grid = ref_data.product_grid(traffic["grid"])
        self.npts = int(self.grid[0].size)
        self.work_per_op = self.nrec * self.npts  # point-records a request
        self.keep_k = int(traffic["check_requests"])
        self.kept = {}  # sampled window requests -> (records, volume)
        self.seen = 0

    def load(self, seed):
        """The seed's coefficients, times and hull, and the Estimate of
        them (one per run: its grid cache is the program's)."""
        cfg, tr = self.cfg, self.traffic
        src = ref_data.make_day(cfg["day"], cfg["MODEL"], seed, 0)
        utime, lat, lon, alt, value, error = ref_data.qc(src, cfg["DEFAULT"])
        n = int(tr["coeff_records"])
        A = ref_model.basis(cfg["MODEL"], lat, lon, alt)
        C = ref_fit.fixed_alpha_fit(value[:n], error[:n], A,
                                    ref_model.psi(cfg["MODEL"]),
                                    10.0 ** tr["coeff_log10_alpha"])
        self.coords = (lat, lon, alt)
        self.C = C
        self.utime = utime[:n]
        inputs = {"C": C, "dC": np.zeros((n,) + C.shape[1:] * 2),
                  "utime": self.utime,
                  "hull_vert": ref_data.hull_vertices(lat, lon, alt),
                  "ini": ini_text(cfg)}
        if self.est is None:
            self.cls.inputs = inputs
            self.est = self.cls(None, device=self.device)
        else:  # another seed in one process: the same grid and geometry
            self.est.Coeffs, self.est.time = C, self.utime
        self.kept, self.seen = {}, 0
        self.rng_keep = np.random.default_rng(
            np.random.SeedSequence([int(seed), 7]))

    def records(self, i):
        n = len(self.utime)
        return [(i * self.nrec + j) % n for j in range(self.nrec)]

    def call(self, i, keep=True):
        recs = self.records(i)
        times = [seconds_of(self.utime[r].mean()) for r in recs]
        vol = self.est.evaluate_records(times, *self.grid, check_hull=True)
        if keep:  # a reservoir sample of the window's requests
            self.seen += 1
            if len(self.kept) < self.keep_k:
                self.kept[i] = (recs, vol)
            else:
                j = int(self.rng_keep.integers(self.seen))
                if j < self.keep_k:
                    del self.kept[sorted(self.kept)[j]]
                    self.kept[i] = (recs, vol)
        return 1

    def failed(self):
        return 0

    def timers(self):
        return [self.est.timer]

    def release(self):
        self.est._prepared_grid = None
        self.est._grid_ev = None

    def check(self, rng, k, control=False):
        """The compared numbers over the kept requests: grid points whose
        NaN state differs from the reference's hull test (every point of
        every record), and the widest gap of a value at sampled FoV points,
        as a share of that point's gross sum sum_n |C_n B_n| (with
        ``control``, the control's hull test and contraction in the
        program's place)."""
        import torch

        dev = self.device
        lat, lon, alt = (torch.as_tensor(np.ravel(g), device=dev)
                         for g in self.grid)
        eqs = ref_product.hull_equations(*self.coords)
        ins = ref_product.inside(eqs, lat, lon, alt).cpu().numpy()
        self.live_points = int(ins.sum())  # the kernel's work counts these
        if control:
            ins_c = ref_product.inside(eqs, lat, lon, alt,
                                       torch.float32).cpu().numpy()
        del lat, lon, alt
        flat = [np.ravel(g) for g in self.grid]
        idx_in = np.flatnonzero(ins)
        mismatch, worst = 0, 0.0
        for i in sorted(self.kept):
            recs, vol = self.kept[i]
            vol = vol.reshape(len(recs), -1)
            pts = np.sort(rng.choice(idx_in, size=min(k, idx_in.size),
                                     replace=False))
            ref, gross = ref_product.field(self.cfg["MODEL"], self.C[recs],
                                           *(f[pts] for f in flat))
            if control:
                got, _ = ref_product.field(self.cfg["MODEL"], self.C[recs],
                                           *(f[pts] for f in flat),
                                           control=True)
                mismatch += int((ins_c != ins).sum()) * len(recs)
            else:
                got = vol[:, pts].astype(np.float64)
                mismatch += int((np.isnan(vol) == ins[None, :]).sum())
            gap = np.abs(got - ref) / gross
            worst = max(worst, float(np.max(np.where(np.isnan(gap), np.inf,
                                                     gap))))
        return {"product_nan_points": float(mismatch),
                "product_value_gap": worst,
                "product_requests_checked": float(len(self.kept))}
