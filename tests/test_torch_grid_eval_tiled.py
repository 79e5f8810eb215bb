"""PyTorch port, grid evaluation at the high orders: what surrounds the
tiled CUDA kernel (csrc/grid_eval_tiled.cu).

``kernel_config`` routes every order whose per-point state would force
grid_eval.cu to one block an SM (maxl 10; maxl 9 with maxk 13-16) to the
tiled kernel, and leaves every other order's build as it was.  The kernel
runs only on the card (chip_smoke.py holds it against the float64 twin);
here ``_tiled_plain`` follows its data flow in float64 torch (the live
points compacted in point order into tiles, the basis table formed from
the packed coef rows with cos/sin(m phi) parked in the last sin rows, the
records' row blocks of ``pack_ceff_rows`` taken a group at a time) and is
held against ``eval_records_plain``, and the contraction's thread map is
mirrored to show that it covers every (point, record) of a tile once.

The JAX package's Pallas kernel in interpret mode at (maxl, maxk) =
(10, 12) takes minutes to compile on a CPU even for 300 points, far beyond
a unit test's budget, so the twin's hold against the JAX package at this
order stays
tests/test_torch_highorder.py::test_grid_evaluator_matches_jax (the JAX
package's XLA float64 evaluator, and the float32 twin within 5e-5 of the
sup); the production order's twin is held against the Pallas kernel in
tests/test_torch_grid_eval.py.
"""

import hashlib

import numpy as np
import pytest
import torch

from volumetricinterp_tpu_torch.config import Config
from volumetricinterp_tpu_torch.coords import geodetic_to_cap, np_geodetic_to_cap
from volumetricinterp_tpu_torch.models.sphharmlag import Model
from volumetricinterp_tpu_torch.ops import grid_eval_cuda as gec
from volumetricinterp_tpu_torch.ops.grid_eval import GridEvaluator

CHUNK = gec.THREADS  # points a block claims at a time
ROUTED = [(10, k) for k in range(1, 17)] + [(9, k) for k in range(13, 17)]


def _evaluator(text, maxl, maxk, n, seed=6):
    text = text.replace("MAXK = 2", f"MAXK = {maxk}").replace(
        "MAXL = 3", f"MAXL = {maxl}")
    model = Model(Config.from_text(text))
    rng = np.random.default_rng(seed)
    lat, lon, alt = (rng.uniform(74, 82, n), rng.uniform(252, 272, n),
                     rng.uniform(1e5, 6e5, n))
    lat[3], lon[3], alt[3] = 40.0, 262.0, 3e5  # off the band: NaN
    _, t, _ = np_geodetic_to_cap(lat, lon, alt, 78.0, 262.0)
    t = np.delete(t, 3)
    ev = GridEvaluator(model, (t.min(), t.max()), dtype=torch.float64,
                       device="cpu")
    pts = [torch.as_tensor(a) for a in (lat, lon, alt)]
    return ev, model, pts


def _pair_rows(ev, cfg):
    """mbar of each pair and the basis row of its sin term (-1: none), as
    the kernel's PairTables."""
    srow, s = [], cfg.npairs
    for m in ev.mbar_pair:
        srow.append(s if m > 0 else -1)
        s += m > 0
    return list(ev.mbar_pair), srow


def _tiled_plain(lat, lon, alt, ceff, ev, cfg, inside=None):
    """The tiled kernel's data flow, in lat's dtype: NaN for the dead
    points, the live ones compacted in point order into tiles of TILE (the
    last one partial, padded with the kernel's benign stage values), each
    tile's basis table [nrows][TILE] from the packed coef rows, the records'
    row blocks a group at a time, the contraction TM points a thread."""
    npts, nrec = lat.shape[0], ceff.shape[0]
    dt, tile = lat.dtype, gec.TILE
    z, theta, c1, s1 = geodetic_to_cap(lat, lon, alt, ev.rot)
    center, inv_half = gec.band_constants(ev, dt)
    u_raw = (theta - center) * inv_half
    live = ~(u_raw.abs() > 1.0 + 1e-4)
    if inside is not None:
        live = live & inside
    u = torch.clamp(u_raw, -1.0, 1.0)
    out = torch.full((nrec, npts), float("nan"), dtype=dt)
    order = torch.nonzero(live).flatten()

    np8 = -(-cfg.npairs // 8) * 8
    coef = torch.zeros((ev.degree, np8), dtype=dt)
    coef[:, :cfg.npp] = ev.coef_packed  # zero past the packed columns
    rows = gec.pack_ceff_rows(ceff, cfg, ev.sin_pairs)
    mbar, srow = _pair_rows(ev, cfg)
    trig0 = cfg.nrows - 2 * (cfg.maxl - 1)
    groups = gec.record_groups(nrec)
    for t0 in range(0, order.numel(), tile):
        idx = order[t0:t0 + tile]
        cnt = idx.numel()
        pad = tile - cnt

        def slot(v, benign):
            return torch.cat([v[idx], torch.full((pad,), benign, dtype=dt)])

        tu, tz, tc, ts = slot(u, 0.0), slot(z, 0.0), slot(c1, 1.0), slot(s1, 0.0)
        basis = torch.full((cfg.nrows, tile), float("nan"), dtype=dt)
        writes = torch.zeros(cfg.nrows, dtype=torch.int64)
        cosm, sinm = [torch.ones_like(tc), tc], [torch.zeros_like(ts), ts]
        for _ in range(2, cfg.maxl):
            cosm.append(2.0 * tc * cosm[-1] - cosm[-2])
            sinm.append(2.0 * tc * sinm[-1] - sinm[-2])
        for m in range(1, cfg.maxl):
            basis[trig0 + m - 1] = cosm[m]
            basis[trig0 + cfg.maxl - 1 + m - 1] = sinm[m]
        T, tm1 = [torch.ones_like(tu)], tu  # T_{-1} = T_1 = u
        for _ in range(1, ev.degree):
            T, tm1 = T + [2.0 * tu * T[-1] - tm1], T[-1]
        P = torch.stack(T, -1) @ coef  # [tile, np8]
        assert not P[:, cfg.npairs:].any()
        ps = {}
        for j in range(cfg.npairs):
            pc = P[:, j]
            if mbar[j] > 0:
                cm = basis[trig0 + mbar[j] - 1].clone()
                ps[j] = pc * basis[trig0 + cfg.maxl - 1 + mbar[j] - 1]
                pc = pc * cm
            assert j < trig0  # a Pc row never overwrites a trig row
            basis[j] = pc
            writes[j] += 1
        for j, v in ps.items():  # after every warp has read the trig rows
            basis[srow[j]] = v
            writes[srow[j]] += 1
        assert (writes == 1).all()  # every basis row formed once
        lag = [torch.ones_like(tz), 1.0 - tz]
        for kk in range(1, cfg.maxkb - 1):
            lag.append(((2 * kk + 1 - tz) * lag[kk] - kk * lag[kk - 1])
                       / (kk + 1.0))
        lagE = torch.stack(lag[:cfg.maxkb]) * torch.exp(-0.5 * tz)  # [maxkb, tile]
        for r0, nr in groups:
            blk = rows[r0:r0 + nr, :cfg.nrows * cfg.maxkb].reshape(
                nr, cfg.nrows, cfg.maxkb)
            S = torch.einsum("jp,rjk->rpk", basis, blk)
            o = (S * lagE.T[None]).sum(-1)
            out[r0:r0 + nr, idx] = o[:, :cnt]
    return out


def _contraction_cells(tm, nr):
    """The (tile point, record) cells each thread of the contraction
    computes, mirroring csrc/grid_eval_tiled.cu::contract; per warp the
    points its lanes read and the records they read."""
    lp = gec.TILE // tm // 4
    rw = 32 // lp
    cells, warps = [], {}
    for tid in range(gec.THREADS):
        warp, lane = divmod(tid, 32)
        pt0 = ((warp & 3) * lp + lane % lp) * tm
        rs = (warp >> 2) * rw + lane // lp
        pts, recs = warps.setdefault(warp, (set(), set()))
        pts.update(range(pt0, pt0 + tm))
        recs.add(rs)
        for rr in range(rs, rs + nr, 2 * rw):
            if rr < nr:
                cells += [(pt0 + p, rr) for p in range(tm)]
    return cells, warps


@pytest.mark.parametrize("order", [(10, 12), (10, 16), (9, 16)])
def test_kernel_config_routes_high_orders_to_tiled(order):
    cfg = gec.kernel_config(*order)
    assert cfg.tiled and cfg.source == gec.TILED_SOURCE
    assert cfg == gec.KernelConfig(order[0], -(-order[1] // 4) * 4, 1, True)
    assert gec.KernelConfig(order[0], cfg.maxkb, 1).live > gec.LIVE_MAX
    assert gec.MINBLOCKS == 2
    assert gec.defines(cfg) == [
        f"-DVI_MAXL={order[0]}", f"-DVI_MAXKB={cfg.maxkb}",
        f"-DVI_TILE={gec.TILE}", f"-DVI_GROUP={gec.GROUP}",
        f"-DVI_THREADS={gec.THREADS}", "-DVI_MINBLOCKS=2"]
    assert gec.library_path(cfg).name.startswith(
        f"grid_eval_tiled_l{order[0]}_k{cfg.maxkb}_")
    # exactly the orders whose live state exceeds LIVE_MAX are routed
    routed = {(l, k) for l in range(1, gec.MAX_L + 1)
              for k in range(1, gec.MAX_K + 1) if gec.kernel_config(l, k).tiled}
    assert routed == set(ROUTED)


@pytest.mark.parametrize("order,pt", [((6, 4), 2), ((2, 9), 2), ((1, 1), 2)])
def test_other_orders_keep_grid_eval_cu_and_its_build_key(order, pt):
    """The production build's defines and cache key are those before the
    tiled kernel existed: the hash of grid_eval.cu and the same flags."""
    cfg = gec.kernel_config(*order)
    assert not cfg.tiled and cfg.source == gec.SOURCE
    assert cfg == gec.KernelConfig(order[0], -(-order[1] // 4) * 4, pt)
    flags = gec.NVCC_FLAGS + [
        f"-DVI_MAXL={order[0]}", f"-DVI_MAXKB={cfg.maxkb}", f"-DVI_PT={pt}",
        f"-DVI_THREADS={gec.THREADS}", "-DVI_MINBLOCKS=2"]
    assert gec.NVCC_FLAGS + gec.defines(cfg) == flags
    digest = hashlib.sha256(gec.SOURCE.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    assert gec.library_path(cfg) == gec.BUILD_DIR / (
        f"grid_eval_l{order[0]}_k{cfg.maxkb}_p{pt}_{digest}.so")


@pytest.mark.parametrize("degree", [28, 256])
def test_tiled_shared_memory_fits_a_block(degree):
    """Every routed order's launch stays within the 227 KB a block may
    take, at any record count (the group buffer holds GROUP records); at
    the band degree of BASELINE config 3 on the config-4 grid (28) two
    blocks of (10, 12) fit an SM's 228 KB."""
    for order in ROUTED:
        cfg = gec.kernel_config(*order)
        sizes = {cfg.smem_bytes(degree, n) for n in (1, 8, 17, 512)}
        assert len(sizes) == 1 and sizes.pop() <= gec.SMEM_MAX
    cfg = gec.kernel_config(10, 12)
    if degree == 28:
        # the kernel's static shared memory (< 64 bytes) and the 1 KB a
        # block the SM keeps
        assert 2 * (cfg.smem_bytes(degree, 8) + 64 + 1024) <= 228 * 1024


@pytest.mark.parametrize("nrec", [1, 8, 17, 512])
def test_record_groups_cover_every_record_once(nrec):
    groups = gec.record_groups(nrec)
    covered = [r for r0, n in groups for r in range(r0, r0 + n)]
    assert covered == list(range(nrec))
    assert all(1 <= n <= gec.GROUP for _, n in groups)
    assert all(n == gec.GROUP for _, n in groups[:-1])
    cfg = gec.kernel_config(10, 12)
    assert gec.record_chunks(cfg, 28, nrec) == [(0, nrec)]  # one launch


@pytest.mark.parametrize("tm", [1, 2, 4])
def test_contraction_map_covers_each_cell_once(tm):
    """Each thread map of the contraction computes every (tile point,
    record) of a group once, for every group size; a warp's basis loads
    cover 32 consecutive points (128 contiguous bytes) and its records'
    coefficient rows start on distinct bank quads."""
    rstride4 = gec.kernel_config(10, 12).rstride // 4
    assert rstride4 % 2 == 1
    for nr in range(1, gec.GROUP + 1):
        cells, warps = _contraction_cells(tm, nr)
        assert sorted(cells) == [(p, r) for p in range(gec.TILE)
                                 for r in range(nr)]
    for pts, recs in warps.values():
        assert len(pts) == 32 and min(pts) % 32 == 0
        assert max(pts) - min(pts) == 31
        assert len({r * rstride4 % 8 for r in recs}) == len(recs)


def test_contraction_tm_by_record_count():
    cfg = gec.kernel_config(10, 12)
    assert gec.contraction_tm(cfg, 8) == 4
    assert gec.contraction_tm(cfg, 512) == 4
    assert gec.contraction_tm(cfg, 1) == 1
    assert all(gec.contraction_tm(cfg, n) in (1, 2, 4) for n in range(1, 40))
    # at maxk bucket 16 the build holds TM 2 at most (its TM_MAX)
    cfg16 = gec.kernel_config(10, 16)
    assert cfg.tm_max == 4 and cfg16.tm_max == 2
    assert all(gec.contraction_tm(cfg16, n) in (1, 2) for n in range(1, 40))


def test_pack_ceff_rows_layout(small_config_text):
    ev, model, _ = _evaluator(small_config_text, 10, 12, 8)
    cfg = gec.kernel_config(10, 12)
    C = np.random.default_rng(1).normal(size=(3, model.nbasis))
    ceff = ev.fold_coeffs(C)
    rows = gec.pack_ceff_rows(ceff, cfg, ev.sin_pairs)
    assert rows.shape == (3, cfg.rstride) and rows.is_contiguous()
    assert cfg.rstride == 4 * 301 and cfg.nrows == 100
    blk = rows[:, :cfg.nrows * cfg.maxkb].reshape(3, cfg.nrows, cfg.maxkb)
    np.testing.assert_array_equal(blk[:, :55].numpy(), ceff[:, 0].numpy())
    sin = ceff[:, 1, torch.as_tensor(ev.mbar_pair > 0)]
    np.testing.assert_array_equal(blk[:, 55:].numpy(), sin.numpy())
    assert not rows[:, cfg.nrows * cfg.maxkb:].any()
    # the sin rows of the mbar = 0 pairs hold nothing the kernel drops
    assert not ceff[:, 1, torch.as_tensor(ev.mbar_pair == 0)].any()


@pytest.mark.parametrize("order,nrec", [((10, 12), 3), ((10, 12), 11),
                                        ((10, 16), 9)])
def test_tiled_layout_matches_twin(small_config_text, order, nrec):
    """The tiled data flow on a ragged point count (neither a multiple of
    a chunk nor of a tile) with a mask, against eval_records_plain on the
    original layout: float64, the same terms summed in another order."""
    n = 3 * CHUNK + 41
    ev, model, (lat, lon, alt) = _evaluator(small_config_text, *order, n)
    cfg = gec.kernel_config(*order)
    C = np.random.default_rng(nrec).normal(size=(nrec, model.nbasis)) * 1e11
    ceff = ev.fold_coeffs(C)
    inside = torch.as_tensor(np.arange(n) % 5 != 2)
    inside[-1] = False
    got = _tiled_plain(lat, lon, alt, ceff, ev, cfg, inside)
    ref = gec.eval_records_plain(lat, lon, alt, ceff, ev, inside)
    np.testing.assert_array_equal(torch.isnan(got), torch.isnan(ref))
    assert torch.isnan(got[:, 3]).all() and torch.isnan(got[:, -1]).all()
    ok = ~torch.isnan(ref)
    live = int(ok[0].sum())
    assert live > 2 * gec.TILE and live % gec.TILE  # a partial last tile
    err = (got - ref)[ok].abs().max()
    assert err <= 1e-11 * ref[ok].abs().max()
