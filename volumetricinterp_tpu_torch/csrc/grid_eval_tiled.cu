// Fused dense-grid evaluation of the sphharmlag model on Hopper (sm_90a),
// built for the high orders: live points compacted into tiles, the basis
// staged in shared memory, the contraction tiled in registers.
//
// Replaces the TPU kernel volumetricinterp_tpu/ops/grid_eval_pallas.py::_kernel
// (launched by eval_records_latlonalt_pallas) at the orders whose per-point
// state does not fit the registers of csrc/grid_eval.cu at two blocks an SM
// (ops/grid_eval_cuda.kernel_config: maxl 10, and maxl 9 with maxk 13-16).
// It computes what that kernel computes, for every grid point i and every
// record r:
//
//   out[r, i] = e^{-z/2} sum_j P_j(u) (cos(mbar_j phi) Rc_rj(z) + sin(mbar_j phi) Rs_rj(z))
//
// with the same fused WGS-84 -> cap transform, the Chebyshev pair series at
// the band degree, cos/sin(mbar phi) and e^{-z/2} L_k(z) by recurrence, and
// NaN off the band (|u| > 1 + 1e-4) and where inside[i] == 0.
//
// What bounds it on an H100.  At (maxl, maxk) = (10, 12) a live point needs
// ~1,200 FMAs of pair series and 1,200 FMAs of contraction per record: with
// 8 records ~11,000 FMAs against 13 bytes in and 32 out, so the FP32 FMA
// pipes, and the issue slots they share with every other instruction, are
// the limit.  The register-resident design of grid_eval.cu holds 112 live
// values a point (55 Pc, 45 Ps, 12 e^{-z/2} L_k), which forces one block of
// 256 threads an SM, and feeds 4 FMAs from each shared-memory load.  This
// kernel spends its registers on FMAs instead:
//
// * Compaction.  A block claims 256-point chunks from a global counter (the
//   next one while it works on the current one), runs the mask test, the transform and the band test, writes the NaN rows of
//   its dead points at once, and appends the live ones (u, z, cos/sin phi
//   and the point's index) to a shared-memory stage in point order (warp
//   ballot and popc).  Only full tiles of TILE points, and the last partial
//   one, go on: a warp that straddles the FoV cone's edge costs no
//   contraction.
// * The basis in shared memory.  Per tile: e^{-z/2} L_k and cos/sin(m phi)
//   by recurrence (a thread a point), then the pair series as a product
//   T(u) x coef: a thread owns 4 points x 8 pairs, runs the T_d recurrence
//   of its 4 points and takes each pair octet's coef row as two LDS.128
//   broadcasts for 32 FMAs.  Pc_j = P_j cos(mbar phi) and Ps = P_j
//   sin(mbar phi) go to a [row][TILE] table: 100 rows at (10, 12), the cos
//   rows in pair order, then the sin rows of the mbar > 0 pairs (the order
//   of grid_eval.cu's sums).  cos/sin(m phi) live in the last sin rows until
//   the series has read them.
// * A register-tiled contraction.  A thread owns TM points (4, 2 or 1,
//   picked per launch by the launcher from the record count) x one record's
//   MAXKB radial sums S_k = sum_row B_row c_row,k.  Per row it loads its TM
//   basis values (one LDS of TM floats) and the record's MAXKB coefficients
//   (LDS.128 broadcasts) for TM x MAXKB FMAs: at TM = 4 one load for each 12
//   FMAs (TM is at most 2 at maxk bucket 16).  The epilogue contracts S_k
//   with e^{-z/2} L_k and stores out[r, idx]; compacted indices come in
//   runs along altitude, so the stores stay mostly coalesced.  With 128
//   registers a thread two blocks of 256 threads share an SM (16 warps),
//   one block's basis phases beside the other's contraction.
// * Every record in one launch.  The records' folded coefficients are
//   packed by the launcher as rows [nrec][RSTRIDE4 float4] (the odd float4
//   stride puts 8 records on distinct bank quads) and copied into shared
//   memory with cp.async a group of up to GROUP records at a time: once per
//   block when all records fit one group, else group by group for each
//   tile.  The transform and the series are formed once per point per
//   launch, whatever the record count.
//
// Tensor cores: TF32 cannot hold 5e-5 of the sup, and a 3xTF32 product's
// ~2^-21 a product sits at the fitted records' bar of 1e-6 of the gross sum
// (gross / sup reaches 54 at (10, 12)); the contraction stays in float32
// FMAs.
//
// Accuracy and subsets.  The arithmetic of a point is that of grid_eval.cu:
// the same transform (libdevice sincospif/sqrtf/atan2f/expf, IEEE
// division), the same recurrences, each pair's series summed over d in
// order, each S_k summed over the rows in order, then sum_k in order.  It
// does not depend on the point's neighbours, its tile, its place after
// compaction, TM or the record count, so any subset of a grid evaluates to
// the same bits.
//
// One instantiation per build, all chosen by the Python launcher
// (ops/grid_eval_cuda.kernel_config): -DVI_MAXL=<4..10>
// -DVI_MAXKB=<4|8|12|16> -DVI_TILE=128 -DVI_GROUP=8 -DVI_THREADS=256
// -DVI_MINBLOCKS=<blocks an SM>; degree <= 256, npts < 2^31.  The launcher
// also packs the tables, picks TM and sizes the shared memory of a launch.

#include <cuda_runtime.h>
#include <stdint.h>

extern __shared__ float4 vi_tiled_smem[];  // the launch's dynamic shared memory

#if !defined(VI_MAXL) || !defined(VI_MAXKB) || !defined(VI_TILE) || \
    !defined(VI_GROUP) || !defined(VI_THREADS) || !defined(VI_MINBLOCKS)
#error "build with -DVI_MAXL -DVI_MAXKB -DVI_TILE -DVI_GROUP -DVI_THREADS -DVI_MINBLOCKS"
#endif

namespace {

constexpr int MAXL = VI_MAXL;
constexpr int MAXKB = VI_MAXKB;            // Laguerre rows, maxk rounded up to 4
constexpr int KQ = MAXKB / 4;              // float4s per coefficient row
constexpr int NP = MAXL * (MAXL + 1) / 2;  // (l, mbar) pairs
constexpr int NS = NP - MAXL;              // pairs with mbar > 0 (sin rows)
constexpr int NROWS = NP + NS;             // basis rows a point: Pc, then Ps
constexpr int NOCT = (NP + 7) / 8;         // pair octets of the series
constexpr int NP8 = NOCT * 8;              // coef row stride in shared memory
constexpr int TILE = VI_TILE;              // points a tile
constexpr int GROUP = VI_GROUP;            // records a shared-memory group
constexpr int kThreads = VI_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int SCAP = TILE + kThreads;      // stage: a partial tile + a chunk
constexpr int RSTRIDE4 = (NROWS * KQ) | 1;  // float4s a record, odd
constexpr int TRIG0 = NROWS - 2 * (MAXL - 1);  // cos/sin(m phi) rows, m >= 1
constexpr int kMaxDegree = 256;
// points a thread of the contraction at most: 4 x 16 accumulators would
// not fit 128 registers beside the loads
constexpr int TM_MAX = MAXKB <= 12 ? 4 : 2;
static_assert(MAXL >= 4 && MAXL <= 10, "4 <= maxl <= 10");
static_assert(NP <= TRIG0, "the trig rows must not overlap the Pc rows");
static_assert(MAXKB % 4 == 0 && MAXKB >= 4 && MAXKB <= 16, "maxk bucket");
static_assert(kThreads == 256 && TILE == 128 && GROUP == 8,
              "the thread maps below assume 8 warps, 32 point quads and "
              "8-record groups");
static_assert(NOCT <= kWarps, "a warp a pair octet");

// float32 roundings of the constants (volumetricinterp_tpu_torch/constants.py)
constexpr float kWgs84A = 0x1.854a64p+22f;        // 6378137 m
constexpr float kWgs84E2 = 0x1.b6b91p-8f;         // first eccentricity^2
constexpr float kOneMinusE2 = 0x1.fc928ep-1f;     // 1 - e^2
constexpr float kInvRE = 0x1.510fa4p-23f;         // 1 / 6371200 m
constexpr float kInv180 = 0x1.6c16c2p-8f;         // 1 / 180

// mbar of each pair and the basis row of its sin term (-1: none)
struct PairTables {
  int mbar[NP8];
  int srow[NP8];
};

constexpr PairTables make_pair_tables() {
  PairTables t{};
  int j = 0;
  for (int l = 0; l < MAXL; ++l)
    for (int m = 0; m <= l; ++m, ++j) {
      t.mbar[j] = m;
      t.srow[j] = m > 0 ? NP + j - l - 1 : -1;
    }
  for (; j < NP8; ++j) {
    t.mbar[j] = 0;
    t.srow[j] = -1;
  }
  return t;
}

__constant__ PairTables c_pairs = make_pair_tables();

struct Args {
  const float* lat;
  const float* lon;
  const float* alt;
  const uint8_t* inside;  // or NULL
  const float4* coef;     // [degree][npp4], zero above each pair's degree
  const float4* ceff;     // [nrec][RSTRIDE4]
  float* out;             // [nrec][npts]
  int* counter;           // chunk counter, 0 at launch
  long long npts;
  int nrec, degree, npp4, tm;
  float theta_c, inv_half, kx, ky, ct0, st0;
};

// The dynamic shared memory, at offsets (in floats) fixed at build time, so
// that no thread keeps a pointer into it in a register: the basis and
// Laguerre tiles, the point stage, the record group buffer, and last the
// coef rows, whose length follows the band degree.
constexpr int OFF_LAGE = NROWS * TILE;
constexpr int OFF_U = OFF_LAGE + MAXKB * TILE;
constexpr int OFF_Z = OFF_U + SCAP;
constexpr int OFF_C1 = OFF_Z + SCAP;
constexpr int OFF_S1 = OFF_C1 + SCAP;
constexpr int OFF_IDX = OFF_S1 + SCAP;
constexpr int OFF_CEFF = OFF_IDX + SCAP;
constexpr int OFF_COEF = OFF_CEFF + 4 * GROUP * RSTRIDE4;
static_assert(OFF_CEFF % 4 == 0 && OFF_COEF % 4 == 0, "float4 alignment");

struct Smem {
  float* const f = reinterpret_cast<float*>(vi_tiled_smem);
  float* const basis = f;             // [NROWS][TILE]
  float* const lagE = f + OFF_LAGE;   // [MAXKB][TILE]
  float* const u = f + OFF_U;         // the stage, [SCAP] each
  float* const z = f + OFF_Z;
  float* const c1 = f + OFF_C1;
  float* const s1 = f + OFF_S1;
  int* const idx = reinterpret_cast<int*>(f + OFF_IDX);
  float4* const ceff = vi_tiled_smem + OFF_CEFF / 4;  // [GROUP][RSTRIDE4]
  float4* const coef = vi_tiled_smem + OFF_COEF / 4;  // [degree][NP8 / 4]
};

__device__ __forceinline__ float comp(const float4& c, int e) {
  return e == 0 ? c.x : e == 1 ? c.y : e == 2 ? c.z : c.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of record group g into the group buffer.
__device__ __forceinline__ void load_group(const Args& a, const Smem& s,
                                           int g) {
  const int r0 = g * GROUP;
  const int n4 = min(GROUP, a.nrec - r0) * RSTRIDE4;
  const float4* src = a.ceff + (long long)r0 * RSTRIDE4;
  for (int t = threadIdx.x; t < n4; t += kThreads) cp_async16(s.ceff + t, src + t);
  cp_async_commit();
}

// The geodetic -> cap transform of point i (grid_eval.cu's arithmetic):
// u clamped to the band, z, cos/sin phi; false when the point is off the
// band.
__device__ __forceinline__ bool cap_point(const Args& a, long long i, float& u,
                                          float& zt, float& c1, float& s1) {
  const float lat = a.lat[i], lon = a.lon[i], alt = a.alt[i];
  // WGS-84 geodetic -> ECEF
  float sla, cla, slo, clo;
  sincospif(lat * kInv180, &sla, &cla);
  sincospif(lon * kInv180, &slo, &clo);
  const float nrad = kWgs84A / sqrtf(1.f - kWgs84E2 * sla * sla);
  const float rho = (nrad + alt) * cla;
  const float x = rho * clo;
  const float y = rho * slo;
  const float zz = (nrad * kOneMinusE2 + alt) * sla;

  // Rodrigues rotation by +theta0 about k = (kx, ky, 0)
  const float omc = 1.f - a.ct0;
  const float kdv = a.kx * x + a.ky * y;
  const float rx = x * a.ct0 + a.ky * zz * a.st0 + a.kx * kdv * omc;
  const float ry = y * a.ct0 - a.kx * zz * a.st0 + a.ky * kdv * omc;
  const float rz = zz * a.ct0 + (a.kx * y - a.ky * x) * a.st0;

  const float r2h = rx * rx + ry * ry;
  const float rho_h = sqrtf(fmaxf(r2h, 1e-30f));
  const float r = sqrtf(r2h + rz * rz);
  const float theta = atan2f(rho_h, rz);
  zt = 100.f * (r * kInvRE - 1.f);
  c1 = rx / rho_h;  // cos/sin phi
  s1 = ry / rho_h;

  const float u_raw = (theta - a.theta_c) * a.inv_half;
  u = fminf(fmaxf(u_raw, -1.f), 1.f);
  return !(fabsf(u_raw) > 1.0001f);
}

// TM consecutive floats of shared memory (TM-float aligned).
template <int TM>
__device__ __forceinline__ void lds(const float* p, float (&v)[TM]) {
  if constexpr (TM == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (TM == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

// The contraction of the tile's cnt points with the group of nr records
// that starts at record r0.  A thread owns TM points x one record; a warp
// holds 32 / (TILE / TM / 4) records of TILE / TM / 4 point groups, so its
// basis loads cover 128 contiguous bytes and its coefficient loads hit
// distinct bank quads (RSTRIDE4 is odd).
template <int TM>
__device__ __forceinline__ void contract(const Args& a, const Smem& s, int r0,
                                         int nr, int cnt) {
  constexpr int LP = TILE / TM / 4;  // point groups a warp
  constexpr int RW = 32 / LP;        // records a warp
  constexpr int RP = 2 * RW;         // records a pass of the block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pt0 = ((warp & 3) * LP + lane % LP) * TM;
  const int rs = (warp >> 2) * RW + lane / LP;
  for (int rr = rs; rr - rs < nr; rr += RP) {
    if (rr >= nr) continue;
    float acc[TM][MAXKB];
#pragma unroll
    for (int p = 0; p < TM; ++p)
#pragma unroll
      for (int k = 0; k < MAXKB; ++k) acc[p][k] = 0.f;
    const float4* cr = s.ceff + rr * RSTRIDE4;
    const float* br = s.basis + pt0;
    // rows an iteration: two at TM = 4, where ptxas spills beyond that at
    // 128 registers, four below
#pragma unroll(TM == 4 ? 2 : 4)
    for (int row = 0; row < NROWS; ++row) {
      float b[TM];
      lds<TM>(br + row * TILE, b);
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        const float4 c = cr[row * KQ + kq];
#pragma unroll
        for (int p = 0; p < TM; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[p][4 * kq + e] = fmaf(b[p], comp(c, e), acc[p][4 * kq + e]);
      }
    }
    float o[TM];
#pragma unroll
    for (int p = 0; p < TM; ++p) o[p] = 0.f;
#pragma unroll
    for (int k = 0; k < MAXKB; ++k) {
      float l[TM];
      lds<TM>(s.lagE + k * TILE + pt0, l);
#pragma unroll
      for (int p = 0; p < TM; ++p) o[p] = fmaf(l[p], acc[p][k], o[p]);
    }
    float* dst = a.out + (long long)(r0 + rr) * a.npts;
#pragma unroll
    for (int p = 0; p < TM; ++p)
      if (pt0 + p < cnt) dst[s.idx[pt0 + p]] = o[p];
  }
}

// Evaluates the stage's first cnt points (cnt <= TILE) at every record.
__device__ __forceinline__ void process_tile(const Args& a, const Smem& s, int cnt,
                             int ngroups) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool resident = ngroups == 1;
  if (!resident) load_group(a, s, 0);  // lands while the basis is formed

  // e^{-z/2} L_k (threads 0..TILE-1) and cos/sin(m phi), m >= 1 (threads
  // TILE..2 TILE-1) of each tile point, by forward recurrence
  if (tid < TILE) {
    const float zt = s.z[tid];
    float lag[MAXKB];
    lag[0] = 1.f;
    lag[1] = 1.f - zt;
#pragma unroll
    for (int kk = 1; kk < MAXKB - 1; ++kk)
      lag[kk + 1] = ((2.f * kk + 1.f - zt) * lag[kk] - kk * lag[kk - 1]) *
                    (1.f / (kk + 1.f));
    const float ez = expf(-0.5f * zt);
#pragma unroll
    for (int k = 0; k < MAXKB; ++k) s.lagE[k * TILE + tid] = lag[k] * ez;
  } else {
    const int p = tid - TILE;
    const float c1 = s.c1[p], s1 = s.s1[p];
    float cosm[MAXL], sinm[MAXL];
    cosm[0] = 1.f;
    sinm[0] = 0.f;
    cosm[1] = c1;
    sinm[1] = s1;
#pragma unroll
    for (int m = 2; m < MAXL; ++m) {
      cosm[m] = 2.f * c1 * cosm[m - 1] - cosm[m - 2];
      sinm[m] = 2.f * c1 * sinm[m - 1] - sinm[m - 2];
    }
#pragma unroll
    for (int m = 1; m < MAXL; ++m) {
      s.basis[(TRIG0 + m - 1) * TILE + p] = cosm[m];
      s.basis[(TRIG0 + MAXL - 1 + m - 1) * TILE + p] = sinm[m];
    }
  }
  __syncthreads();

  // The pair series: warp po takes pairs 8 po .. 8 po + 7, lane q the tile
  // points 4 q .. 4 q + 3.  Starting from T_{-1} = T_1 = u, T_0 = 1 the
  // first step gives T_1 = u exactly.
  float4 ps[8];
  const int po = warp, q = lane;
  if (po < NOCT) {
    float uu[4];
    lds<4>(s.u + 4 * q, uu);
    float P[4][8];
    {
      const float4 ca = s.coef[2 * po], cb = s.coef[2 * po + 1];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          P[p][e] = comp(ca, e);
          P[p][4 + e] = comp(cb, e);
        }
    }
    float tm1[4], t[4], two_u[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      tm1[p] = uu[p];
      t[p] = 1.f;
      two_u[p] = 2.f * uu[p];
    }
#pragma unroll 2
    for (int d = 1; d < a.degree; ++d) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float tn = fmaf(two_u[p], t[p], -tm1[p]);
        tm1[p] = t[p];
        t[p] = tn;
      }
      const float4* row = s.coef + d * (NP8 / 4) + 2 * po;
      const float4 ca = row[0], cb = row[1];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          P[p][e] = fmaf(comp(ca, e), t[p], P[p][e]);
          P[p][4 + e] = fmaf(comp(cb, e), t[p], P[p][4 + e]);
        }
    }
    // Pc_j = P_j cos(mbar phi) to its row now; Ps_j = P_j sin(mbar phi)
    // kept until every warp has read the trig rows it overwrites
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = 8 * po + e;
      if (j >= NP) continue;
      const int mb = c_pairs.mbar[j];
      float4 pc = make_float4(P[0][e], P[1][e], P[2][e], P[3][e]);
      if (mb > 0) {
        float cm[4], sm[4];
        lds<4>(s.basis + (TRIG0 + mb - 1) * TILE + 4 * q, cm);
        lds<4>(s.basis + (TRIG0 + MAXL - 1 + mb - 1) * TILE + 4 * q, sm);
        ps[e] = make_float4(pc.x * sm[0], pc.y * sm[1], pc.z * sm[2],
                            pc.w * sm[3]);
        pc = make_float4(pc.x * cm[0], pc.y * cm[1], pc.z * cm[2],
                         pc.w * cm[3]);
      }
      *reinterpret_cast<float4*>(s.basis + j * TILE + 4 * q) = pc;
    }
  }
  __syncthreads();
  if (po < NOCT) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = 8 * po + e;
      if (j < NP && c_pairs.srow[j] >= 0)
        *reinterpret_cast<float4*>(s.basis + c_pairs.srow[j] * TILE + 4 * q) =
            ps[e];
    }
  }
  if (!resident) cp_async_wait_all();
  __syncthreads();

  for (int g = 0; g < ngroups; ++g) {
    if (!resident && g > 0) {
      load_group(a, s, g);
      cp_async_wait_all();
      __syncthreads();
    }
    const int nr = min(GROUP, a.nrec - g * GROUP);
    if (TM_MAX == 4 && a.tm == 4)
      contract<TM_MAX>(a, s, g * GROUP, nr, cnt);
    else if (a.tm == 2)
      contract<2>(a, s, g * GROUP, nr, cnt);
    else
      contract<1>(a, s, g * GROUP, nr, cnt);
    if (!resident && g + 1 < ngroups) __syncthreads();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, VI_MINBLOCKS)
grid_eval_tiled_kernel(Args a) {
  const Smem s{};
  __shared__ int s_chunk;
  __shared__ int s_wcount[kWarps];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ngroups = (a.nrec + GROUP - 1) / GROUP;
  if (ngroups == 1) load_group(a, s, 0);
  // coef rows widened to NP8 columns, zero past the packed ones
  for (int t = tid; t < a.degree * (NP8 / 4); t += kThreads) {
    const int d = t / (NP8 / 4), c = t - d * (NP8 / 4);
    s.coef[t] = c < a.npp4 ? a.coef[d * a.npp4 + c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // finite values in the stage slots a partial tile reads past its points
  for (int t = tid; t < SCAP; t += kThreads) {
    s.u[t] = 0.f;
    s.z[t] = 0.f;
    s.c1[t] = 1.f;
    s.s1[t] = 0.f;
    s.idx[t] = 0;
  }
  if (tid == 0) s_chunk = atomicAdd(a.counter, 1);
  if (ngroups == 1) cp_async_wait_all();
  __syncthreads();

  const float kNaN = __int_as_float(0x7fc00000);
  int n_stage = 0;  // the same in every thread
  for (bool done = false; !done;) {
    const long long i = (long long)s_chunk * kThreads + tid;
    // past the last chunk: the stage's last, partial tile, and out
    done = (long long)s_chunk * kThreads >= a.npts;
    // thread 0 claims the next chunk now and publishes it after the
    // compaction, so that the atomic's round trip overlaps the transform
    int next = 0;
    if (tid == 0) next = atomicAdd(a.counter, 1);
    bool live = false;
    float u = 0.f, zt = 0.f, c1 = 1.f, s1 = 0.f;
    if (i < a.npts) {
      // the mask first: a masked point skips the transform
      live = !a.inside || a.inside[i];
      if (live) live = cap_point(a, i, u, zt, c1, s1);
      if (!live)
        for (int r = 0; r < a.nrec; ++r) a.out[r * a.npts + i] = kNaN;
    }
    // append the live points to the stage in point order
    const unsigned ball = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_wcount[warp] = __popc(ball);
    __syncthreads();
    int base = n_stage, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_wcount[w];
      base += w < warp ? c : 0;
      total += c;
    }
    if (live) {
      const int pos = base + __popc(ball & ((1u << lane) - 1u));
      s.u[pos] = u;
      s.z[pos] = zt;
      s.c1[pos] = c1;
      s.s1[pos] = s1;
      s.idx[pos] = (int)i;
    }
    if (tid == 0) s_chunk = next;  // every thread read it before the last barrier
    n_stage += total;
    __syncthreads();
    while (n_stage >= TILE || (done && n_stage > 0)) {
      const int cnt = min(n_stage, TILE);
      process_tile(a, s, cnt, ngroups);
      n_stage -= cnt;
      // move the rest of the stage (< kThreads entries) to its front
      float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
      int v4 = 0;
      const bool mine = tid < n_stage;
      if (mine) {
        v0 = s.u[TILE + tid];
        v1 = s.z[TILE + tid];
        v2 = s.c1[TILE + tid];
        v3 = s.s1[TILE + tid];
        v4 = s.idx[TILE + tid];
      }
      __syncthreads();
      if (mine) {
        s.u[tid] = v0;
        s.z[tid] = v1;
        s.c1[tid] = v2;
        s.s1[tid] = v3;
        s.idx[tid] = v4;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// This library's instantiation: {maxl, maxk bucket, tile points, records a
// group, threads per block, min blocks an SM, most points a thread of the
// contraction}.
void vi_grid_eval_tiled_config(int* out) {
  out[0] = MAXL;
  out[1] = MAXKB;
  out[2] = TILE;
  out[3] = GROUP;
  out[4] = kThreads;
  out[5] = VI_MINBLOCKS;
  out[6] = TM_MAX;
}

// Dynamic shared memory a launch needs at this band degree.
long long vi_grid_eval_tiled_smem(int degree) {
  return 4LL * OFF_COEF + 16LL * degree * (NP8 / 4);
}

// Evaluates nrec records at npts points in one launch; returns a
// cudaError_t value (0 on success).  Arrays: lat/lon/alt [npts] float32
// degrees/metres, inside [npts] uint8 or NULL, coef [degree][npp] float32
// zero above each pair's degree (npp a multiple of 4, NP <= npp <= NP8),
// ceff [nrec][4 RSTRIDE4] float32 (the launcher's row packing; 16-byte
// aligned), out [nrec][npts], counter one int32 set to 0.  tm: points a
// thread of the contraction (1, 2 or 4, at most TM_MAX).  smem must be at
// least
// vi_grid_eval_tiled_smem(degree).
int vi_grid_eval_tiled(const float* lat, const float* lon, const float* alt,
                       const uint8_t* inside, const float* coef, int npp,
                       const float* ceff, float* out, int* counter,
                       long long npts, int nrec, int degree, int tm,
                       float theta_c, float inv_half, float kx, float ky,
                       float ct0, float st0, long long smem, void* stream) {
  if (degree < 1 || degree > kMaxDegree || npts < 0 || npts > 0x7fffffffLL ||
      nrec < 0 || npp % 4 != 0 || npp < NP || npp > NP8 ||
      !(tm == 1 || tm == 2 || tm == 4) || tm > TM_MAX ||
      smem < vi_grid_eval_tiled_smem(degree))
    return (int)cudaErrorInvalidValue;
  if (npts == 0 || nrec == 0) return 0;
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(grid_eval_tiled_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grid_eval_tiled_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long nchunks = (npts + kThreads - 1) / kThreads;
  const long long fit = (long long)per_sm * nsm;
  Args a{lat, lon, alt, inside,
         reinterpret_cast<const float4*>(coef),
         reinterpret_cast<const float4*>(ceff),
         out, counter, npts, nrec, degree, npp / 4, tm, theta_c, inv_half, kx, ky, ct0, st0};
  grid_eval_tiled_kernel<<<(unsigned)(nchunks < fit ? nchunks : fit), kThreads,
                           (size_t)smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* vi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
