"""The PyTorch port stands alone: it imports and runs its plain path (and
the reference-API surface: Interpolate.eval_C, the device hull test,
Model.design_from_ztp, Estimate.check_hull) in a process where jax (and,
separately, h5py) cannot be imported, never imports the JAX package, and
refuses a CUDA device it does not have."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of it raises ImportError
import numpy as np
import torch
import volumetricinterp_tpu_torch as vt
import volumetricinterp_tpu_torch.cli
import volumetricinterp_tpu_torch.validate
from volumetricinterp_tpu_torch.config import Config
from volumetricinterp_tpu_torch.io.amisr import qc_datasets
from volumetricinterp_tpu_torch.io.synth import synthetic_amisr_datasets
from volumetricinterp_tpu_torch.models.sphharmlag import Model
from volumetricinterp_tpu_torch.ops.fit import fit_records
from volumetricinterp_tpu_torch.ops.grid_eval import GridEvaluator
from volumetricinterp_tpu_torch.ops.timejoint import fit_time_coupled
from volumetricinterp_tpu_torch.ops.timesmooth import (eval_time_spline,
                                                       fit_time_spline)
from volumetricinterp_tpu_torch.io.amisr import beam_indices
from volumetricinterp_tpu_torch.models import make_model
from volumetricinterp_tpu_torch.ops.grid_eval import RBFGridEvaluator
from volumetricinterp_tpu_torch.parallel import make_mesh
from volumetricinterp_tpu_torch.parallel.distributed import (
    initialize_distributed)
from volumetricinterp_tpu_torch.sweep import lobo_cv
from volumetricinterp_tpu_torch.utils.profiling import debug_mode, trace
from volumetricinterp_tpu_torch.utils.hull import (
    check_hull, compute_hull_vertices, hull_equations, np_check_hull)

cfg = Config.from_text('''
[DEFAULT]
REGULARIZATION_LIST = 0thorder
[MODEL]
MAXK = 2
MAXL = 3
[TPU]
QUAD_MODE = gauss
''')
model = Model(cfg)
d = synthetic_amisr_datasets(nrec=6, seed=2, smooth_in_model=model)
ut, lat, lon, alt, v, e = qc_datasets(d, "dens", [1e10, 1e13], [0.1, 10],
                                      [1, 2, 3, 4])
A = model.basis(lat, lon, alt)
tau = model.eval_tau(lambda z: 1e11 * np.exp(-z)).reshape(1, -1)
C, dC, chi2, rp = fit_records(v, e, A, model.eval_psi()[None], device="cpu",
                              reg_taus=tau)
assert torch.isfinite(chi2).all() and (rp >= 0).all()
Cj, chi2j = fit_time_coupled(v, e, A, model.eval_psi()[None],
                             np.log10(rp.numpy() + 1e-30), 1e-4, device="cpu")
tf = fit_time_spline(ut.mean(axis=1), Cj, lam="gcv")
assert np.isfinite(eval_time_spline(tf, ut[2].mean())).all()
G = model.grad_basis(lat, lon, alt)
assert G.shape == A.shape[:-1] + (3, model.nbasis) and np.isfinite(G).all()
vec = model.inverse_transform(lat, lon, alt, G[..., 0])
assert vec.shape == A.shape[:-1] + (3,)
_, t, _ = model.transform_coord(lat, lon, alt)
ev = GridEvaluator(model, (t.min(), t.max()), device="cpu")
out = ev.eval_records(C.numpy(), lat, lon, alt).numpy()
ref = (A @ C.numpy().T).T
assert np.max(np.abs(out - ref)) < 5e-5 * np.max(np.abs(ref))
scores, per = lobo_cv(v, e, A, beam_indices(d), model.eval_psi(), [-22.0],
                      device="cpu")
assert per.shape == (6, 20, 1) and np.isfinite(scores).all()
assert initialize_distributed(device="cpu") == (0, 1)
assert make_mesh().size == 1
rbf = make_model("radbasfun", Config.from_text("[MODEL]\nNUMGRIDPNT = 3\n"))
Ar = rbf.basis(lat, lon, alt)
with debug_mode():
    out = RBFGridEvaluator(rbf, device="cpu").eval_records(
        np.ones((1, 27)), lat, lon, alt).numpy()
assert np.max(np.abs(out[0] - Ar.sum(-1))) < 5e-5 * np.max(Ar.sum(-1))
psi = {{"0thorder": model.eval_psi()}}
Cv = vt.Interpolate(cfg, device="cpu").eval_C(A, v[0], e[0] ** -2.0, psi,
                                              {{"0thorder": 1e-23}})
assert Cv.shape == (model.nbasis,) and torch.isfinite(Cv).all()
zz, tt, pp = model.transform_coord(lat, lon, alt)
Ad = model.design_from_ztp(*(torch.as_tensor(q) for q in (zz, tt, pp)))
assert np.abs(Ad.numpy() - A.reshape(Ad.shape)).max() <= 1e-12 * np.abs(A).max()
vert = compute_hull_vertices(lat, lon, alt)
eqs = hull_equations(vert)
inside = check_hull(eqs, lat, lon, alt, device="cpu", chunk=100).numpy()
assert np.array_equal(inside, np_check_hull(eqs, lat, lon, alt))


class MemEstimate(vt.Estimate):
    def loadh5(self, filename=None):
        self.Coeffs, self.Covariance = C.numpy(), dC.numpy()
        self.time, self.hull_vert = ut, vert
        self.config_file_text = cfg.raw_text
        self.chi2, self.raw_filename, self.timefit = chi2.numpy(), None, None


assert np.array_equal(MemEstimate(None, device="cpu").check_hull(lat, lon, alt),
                      inside)
for make in (lambda: GridEvaluator(model, (t.min(), t.max()), device="cuda"),
             lambda: RBFGridEvaluator(rbf, device="cuda"),
             lambda: vt.Interpolate(cfg, device="cuda"),
             lambda: MemEstimate(None).check_hull(lat, lon, alt),
             lambda: check_hull(eqs, lat, lon, alt)):
    try:
        make()
    except RuntimeError:
        pass
    else:
        raise SystemExit("the CUDA default did not raise without CUDA")
assert not any(m == "jax" or m.startswith(("jax.", "volumetricinterp_tpu."))
               or m == "volumetricinterp_tpu" for m in sys.modules
               if sys.modules[m] is not None)
print("OK")
"""


@pytest.mark.parametrize("blocked", [("jax",), ("jax", "h5py")],
                         ids=["no-jax", "no-jax-no-h5py"])
def test_port_runs_without_jax(blocked):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", SCRIPT.format(blocked=blocked)],
                         cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def test_no_jax_imports_in_the_port():
    pat = re.compile(r"^\s*(import|from)\s+(jax|volumetricinterp_tpu)\b",
                     re.M)
    files = sorted((ROOT / "volumetricinterp_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f
