"""PyTorch port, grid evaluation: what surrounds the CUDA kernel.

The kernel reads packed tables (coef zero-padded above each pair's degree
in rows of four, ceff with maxk padded to four), takes PT consecutive
points per thread with clamped loads at the ragged end, and launches once
per record chunk.  The kernel runs only on the card (chip_smoke.py holds
it against the twin); here ``_packed_plain`` evaluates the kernel's own
factorisation from the packed layout, in float64, and is held against
``eval_records_plain`` on the original layout.  The twin itself is held
against the TPU kernel in interpret mode by
tests/test_torch_grid_eval.py::test_f32_twin_matches_pallas_interpret.
"""

import numpy as np
import pytest
import torch

from volumetricinterp_tpu_torch.config import Config
from volumetricinterp_tpu_torch.coords import geodetic_to_cap, np_geodetic_to_cap
from volumetricinterp_tpu_torch.models.sphharmlag import Model
from volumetricinterp_tpu_torch.ops import grid_eval_cuda as gec
from volumetricinterp_tpu_torch.ops.grid_eval import GridEvaluator

NRAG = 2 * gec.THREADS * 4 + 7  # not a multiple of PT or of a block's points


def _evaluator(text, maxl, maxk, n, seed=4):
    text = text.replace("MAXK = 2", f"MAXK = {maxk}").replace(
        "MAXL = 3", f"MAXL = {maxl}")
    model = Model(Config.from_text(text))
    rng = np.random.default_rng(seed)
    lat, lon, alt = (rng.uniform(74, 82, n), rng.uniform(252, 272, n),
                     rng.uniform(1e5, 6e5, n))
    lat[0], lon[0], alt[0] = 40.0, 262.0, 3e5  # off the band: NaN
    _, t, _ = np_geodetic_to_cap(lat[1:], lon[1:], alt[1:], 78.0, 262.0)
    ev = GridEvaluator(model, (t.min(), t.max()), dtype=torch.float64,
                       device="cpu")
    C = rng.normal(size=(3, model.nbasis)) * 1e11
    pts = [torch.as_tensor(a) for a in (lat, lon, alt)]
    return ev, C, pts


def _packed_plain(lat, lon, alt, coef_p, ceff_p, ev, cfg, inside=None):
    """The kernel's arithmetic from the packed tables, point groups of PT
    with the ragged end's loads clamped to the last point, in lat's dtype."""
    npts, nrec = lat.shape[0], ceff_p.shape[0]
    ngroups = -(-npts // cfg.pt)
    idx = torch.clamp(torch.arange(ngroups * cfg.pt), max=npts - 1)
    z, theta, c1, s1 = geodetic_to_cap(lat[idx], lon[idx], alt[idx], ev.rot)
    center, inv_half = gec.band_constants(ev, lat.dtype)
    u_raw = (theta - center) * inv_half
    u = torch.clamp(u_raw, -1.0, 1.0)
    T, tm1 = [torch.ones_like(u)], u  # T_{-1} = T_1 = u
    for _ in range(1, coef_p.shape[0]):
        T, tm1 = T + [2.0 * u * T[-1] - tm1], T[-1]
    P = torch.stack(T, dim=-1) @ coef_p  # [n, NPP]
    assert not P[:, cfg.npairs:].any()  # padding columns are zero
    P = P[:, :cfg.npairs]
    cosm, sinm = [torch.ones_like(c1), c1], [torch.zeros_like(s1), s1]
    for _ in range(2, cfg.maxl):
        cosm.append(2.0 * c1 * cosm[-1] - cosm[-2])
        sinm.append(2.0 * c1 * sinm[-1] - sinm[-2])
    mbar = torch.as_tensor(ev.mbar_pair)
    Pc = P * torch.stack(cosm, -1)[:, mbar]
    Ps = (P * torch.stack(sinm, -1)[:, mbar])[:, mbar > 0]
    lag = [torch.ones_like(z), 1.0 - z]
    for kk in range(1, cfg.maxkb - 1):
        lag.append(((2 * kk + 1 - z) * lag[kk] - kk * lag[kk - 1])
                   / (kk + 1.0))
    lagE = torch.stack(lag[:cfg.maxkb], -1) * torch.exp(-0.5 * z)[:, None]
    nan = u_raw.abs() > 1.0 + 1e-4
    if inside is not None:
        nan = nan | ~inside[idx]
    out = torch.empty((nrec, ngroups * cfg.pt), dtype=lat.dtype)
    for r in range(nrec):
        S = Pc @ ceff_p[r, 0] + Ps @ ceff_p[r, 1][mbar > 0]  # [n, MAXKB]
        out[r] = torch.where(nan, float("nan"), (S * lagE).sum(-1))
    return out[:, :npts]  # the clamped copies are never stored


@pytest.mark.parametrize("maxk", [1, 4, 5])
@pytest.mark.parametrize("maxl", [1, 2, 6, 10])
def test_packed_layout_matches_twin(small_config_text, maxl, maxk):
    ev, C, (lat, lon, alt) = _evaluator(small_config_text, maxl, maxk, NRAG)
    cfg = gec.kernel_config(maxl, maxk)
    assert cfg.maxkb == -(-maxk // 4) * 4 and cfg.npp % 4 == 0
    assert (cfg.pt == 1 or NRAG % cfg.pt) and NRAG % (gec.THREADS * cfg.pt)

    coef_p = ev.coef_packed
    assert coef_p.shape == (ev.degree, cfg.npp)
    assert coef_p.shape[1] * 4 % 16 == 0  # float32 rows of whole LDS.128s
    d = np.arange(ev.degree)[:, None]
    want = np.where(d < ev.pair_degree[None, :], ev.table.coef, 0.0)
    np.testing.assert_array_equal(coef_p[:, :ev.npairs].numpy(), want)
    assert not coef_p[:, ev.npairs:].any()

    ceff = ev.fold_coeffs(C)
    ceff_p = gec.pack_ceff(ceff)
    assert ceff_p.shape == (3, 2, ev.npairs, cfg.maxkb)
    np.testing.assert_array_equal(ceff_p[..., :maxk].numpy(), ceff.numpy())
    assert not ceff_p[..., maxk:].any()

    inside = torch.as_tensor(np.arange(NRAG) % 5 != 2)
    inside[-1] = False  # the ragged end's clamp source is masked
    got = _packed_plain(lat, lon, alt, coef_p, ceff_p, ev, cfg, inside)
    ref = gec.eval_records_plain(lat, lon, alt, ceff, ev, inside)
    np.testing.assert_array_equal(torch.isnan(got), torch.isnan(ref))
    assert torch.isnan(got[:, 0]).all() and torch.isnan(got[:, -1]).all()
    ok = ~torch.isnan(ref)
    assert ok.sum() > NRAG  # most points are live
    # float64, the same terms summed in another order
    err = (got - ref)[ok].abs().max()
    assert err <= 1e-11 * ref[ok].abs().max()


def test_kernel_config_points_per_thread():
    # the production order keeps two points a thread; maxl=10, whose live
    # state would force one block an SM, goes to the tiled kernel
    assert gec.kernel_config(6, 4) == gec.KernelConfig(6, 4, 2)
    assert gec.kernel_config(3, 2) == gec.KernelConfig(3, 4, 2)
    assert gec.kernel_config(10, 16) == gec.KernelConfig(10, 16, 1, True)
    assert gec.kernel_config(6, 4).minblocks == 2
    assert gec.kernel_config(10, 16).minblocks == 2
    # more than one point a thread only where the launch bounds still keep
    # two blocks an SM; the build passes them to the kernel
    for maxl in range(1, gec.MAX_L + 1):
        for maxk in range(1, gec.MAX_K + 1):
            cfg = gec.kernel_config(maxl, maxk)
            assert cfg.pt in (1, 2)
            assert cfg.pt == 1 or cfg.minblocks == 2
            assert f"-DVI_MINBLOCKS={cfg.minblocks}" in gec.defines(cfg)
            assert (f"-DVI_PT={cfg.pt}" in gec.defines(cfg)) != cfg.tiled


@pytest.mark.parametrize("maxl,maxk,degree,nrec", [
    (6, 4, 20, 8), (6, 4, 20, 512), (10, 16, 256, 40), (1, 1, 1, 3)])
def test_record_chunks_cover_records_within_budget(maxl, maxk, degree, nrec):
    cfg = gec.kernel_config(maxl, maxk)
    chunks = gec.record_chunks(cfg, degree, nrec)
    assert [r0 for r0, _ in chunks] == list(
        np.cumsum([0] + [n for _, n in chunks[:-1]]))
    assert sum(n for _, n in chunks) == nrec
    # the tiled kernel (maxl 10) takes every record in one launch within
    # what a block may take; grid_eval.cu's chunks stay in its budget
    budget = gec.SMEM_MAX if cfg.tiled else gec.SMEM_BUDGET
    assert all(n >= 1 and cfg.smem_bytes(degree, n) <= budget
               for _, n in chunks)
    # a chunk is full unless it is the last
    per = chunks[0][1]
    assert all(n == per for _, n in chunks[:-1])
    assert per == nrec or cfg.smem_bytes(degree, per + 1) > budget
    # each chunk's tables start 16-byte aligned in the packed ceff
    assert all(r0 * 2 * cfg.npairs * cfg.maxkb * 4 % 16 == 0
               for r0, _ in chunks)


def test_record_chunks_split_a_keogram():
    cfg = gec.kernel_config(6, 4)
    chunks = gec.record_chunks(cfg, 20, 512)
    assert len(chunks) == 4 and chunks[-1] == (429, 83)


def test_vector_ok_needs_whole_groups_and_alignment():
    cfg = gec.kernel_config(6, 4)  # PT = 2
    a = torch.zeros(1026, dtype=torch.float32)
    assert gec.vector_ok(cfg, 1026, a, a)
    assert not gec.vector_ok(cfg, 1025, a[:1025])  # ragged end
    assert not gec.vector_ok(cfg, 1024, a[1:1025])  # 4-byte offset
    assert gec.vector_ok(cfg, 1024, a[2:1026])


def test_pack_ceff_copies_only_to_pad_or_align():
    ceff = torch.randn(5, 2, 21, 4)
    assert gec.pack_ceff(ceff) is ceff
    shifted = torch.randn(5 * 2 * 21 * 4 + 1)[1:].view(5, 2, 21, 4)
    assert shifted.data_ptr() % 16 == 4
    packed = gec.pack_ceff(shifted)
    assert packed.data_ptr() % 16 == 0 and torch.equal(packed, shifted)
