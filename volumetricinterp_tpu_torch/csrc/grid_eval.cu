// Fused dense-grid evaluation of the sphharmlag model on Hopper (sm_90a).
//
// Replaces the TPU kernel volumetricinterp_tpu/ops/grid_eval_pallas.py::_kernel
// (launched by eval_records_latlonalt_pallas).  For every grid point and
// every record r of a launch it computes
//
//   out[r, i] = e^{-z/2} sum_j P_j(u) (cos(mbar_j phi) Rc_rj(z) + sin(mbar_j phi) Rs_rj(z))
//
// with P_j(u) = sum_{d < deg_j} coef[d, j] T_d(u) the band-refitted
// Chebyshev series of pair j, u the colatitude mapped onto the fitted band,
// and Rc/Rs_rj(z) = sum_k ceff[r, {0,1}, j, k] L_k(z) the record's radial
// contraction.  The geodetic -> cap transform is fused: WGS-84 ECEF, the
// reference's Rodrigues rotation by +theta0 about k = (kx, ky, 0)
// (docs/PARITY_NOTES.md #1), r, colatitude atan2(rho, rz) (the angle the TPU
// kernel forms as atan2(sqrt(1 - q^2), q), without the cancellation) and
// z = 100 (r / RE - 1).  Points off the band (|u| > 1 + 1e-4) and points
// with inside[i] == 0 are NaN.
//
// What bounds it on an H100.  The work is ~sum_j deg_j + degree FMAs of
// pair series per point (~360 at the production order) and ~nbasis = 144
// FMAs of contraction per point-record, against 12-13 bytes in per point
// and 4 bytes out per point-record: compute-bound by far.  Each of an SM's
// four schedulers issues one warp instruction per clock, the rate of its
// FP32 FMA pipe, so every instruction that is not an FFMA takes an FMA's
// slot: the limit is issue slots first, then FMAs.  The design spends the
// slots on FMAs:
//
// * Shared Chebyshev rows.  A thread runs the T_d(u) recurrence once and
//   adds coef[d, :] T_d into all NP pair sums, the loop over pairs unrolled
//   at compile time.  coef comes zero-padded above each pair's own degree
//   (packed in Python), so every pair runs to the band degree: that costs
//   sum_j (degree - deg_j) FMAs of zeros (~80 at the production band) and
//   removes per-pair loops with runtime trip counts, their compares,
//   branches and address arithmetic.  (Keeping the truncation would need
//   the pairs bucketed by degree at build time, one code path per band.)
// * PT consecutive points per thread (VI_PT).  Every coefficient read from
//   shared memory feeds PT FMAs.  PT is set per instantiation from the
//   registers a point holds through the record loop
//   (ops/grid_eval_cuda.kernel_config).  Consecutive points keep the loads
//   of lat/lon/alt and the stores of each record row PT-wide vector
//   accesses, coalesced across the warp, and the FoV mask's runs (altitude
//   is the fastest grid axis) uniform within a warp.
// * Factored contraction.  Per point, Pc_j = P_j cos(mbar_j phi),
//   Ps_j = P_j sin(mbar_j phi) and e^{-z/2} L_k(z) are formed once; per
//   record S_k = sum_j Pc_j ceff[r,0,j,k] + Ps_j ceff[r,1,j,k] and
//   out = sum_k e^{-z/2} L_k S_k: nbasis + MAXKB FMAs per point-record.
// * Vector shared loads.  coef is laid out [degree][NPP] (NPP = NP rounded
//   up to 4) and ceff [rec][branch][pair][MAXKB] (maxk rounded up to 4,
//   zero-padded), 16-byte aligned, so one LDS.128 broadcast brings four
//   coefficients for 4 PT FMAs.
// * Persistent blocks.  The grid holds as many blocks as fit on the SMs at
//   once; each stages the tables into shared memory once and walks over
//   point groups in a grid-stride loop.  Records beyond the shared-memory
//   budget go to further launches (ops/grid_eval_cuda.record_chunks).
//
// TMA would bring little: the point stream is 12-13 bytes per point read
// once, and the tables are a few KB staged once per block.  Tensor cores:
// TF32 (unit roundoff ~4.9e-4) cannot hold the 5e-5-of-sup bar.  fp64
// DMMA peaks at the FP32 FMA pipe's rate, so it cannot be faster.  A
// 3xTF32 split product could speed the contraction where it dominates
// (keogram launches of hundreds of records) but was left: its A operand,
// 16 points x nbasis in hi and lo parts, does not fit a thread's registers
// beside the rest, and that launch is a small share of any product's wall
// time (PERF.md, findings).
//
// Accuracy: libdevice sincospif/sqrtf/atan2f/expf with IEEE division
// (built without --use_fast_math); sincospif of degrees / 180 reduces its
// argument exactly and has no large-argument branch.  The error envelope is set by float32
// theta resolution (~1e-7 rad times dP/dtheta ~ nu), ~5e-5 of the sup for
// coefficients of one scale; a fitted record whose terms cancel ~1e3-fold
// (sub-cutoff coefficient directions) sits at float32 rounding of its gross
// sum sum_n |C_n B_n|, as the TPU kernel does.  A point's arithmetic does
// not depend on its neighbours, its place in a group or the launch's
// record count, so any subset of a grid evaluates bit-identically.
//
// One instantiation per build, all chosen by the Python launcher
// (ops/grid_eval_cuda.kernel_config): -DVI_MAXL=<1..10> -DVI_MAXKB=<4|8|12|16>
// -DVI_PT=<1|2> -DVI_THREADS=<threads a block> -DVI_MINBLOCKS=<1|2>;
// degree <= 256.  The launcher also checks the inputs and sizes the shared
// memory of each launch.

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(VI_MAXL) || !defined(VI_MAXKB) || !defined(VI_PT) || \
    !defined(VI_THREADS) || !defined(VI_MINBLOCKS)
#error "build with -DVI_MAXL -DVI_MAXKB -DVI_PT -DVI_THREADS -DVI_MINBLOCKS"
#endif

namespace {

constexpr int MAXL = VI_MAXL;
constexpr int MAXKB = VI_MAXKB;             // Laguerre rows, maxk rounded up to 4
constexpr int PT = VI_PT;                   // consecutive points per thread
constexpr int NP = MAXL * (MAXL + 1) / 2;   // (l, mbar) pairs
constexpr int NPP = (NP + 3) / 4 * 4;       // coef row stride
constexpr int NS = NP - MAXL;               // pairs with mbar > 0 (sin branch)
constexpr int KQ = MAXKB / 4;               // float4s per ceff row
constexpr int kThreads = VI_THREADS;
constexpr int kMaxDegree = 256;
static_assert(MAXL >= 1 && MAXL <= 10, "1 <= maxl <= 10");
static_assert(MAXKB % 4 == 0 && MAXKB >= 4 && MAXKB <= 16, "maxk bucket");
static_assert(PT == 1 || PT == 2, "points per thread");

// float32 roundings of the constants (volumetricinterp_tpu_torch/constants.py)
constexpr float kWgs84A = 0x1.854a64p+22f;        // 6378137 m
constexpr float kWgs84E2 = 0x1.b6b91p-8f;         // first eccentricity^2
constexpr float kOneMinusE2 = 0x1.fc928ep-1f;     // 1 - e^2
constexpr float kInvRE = 0x1.510fa4p-23f;         // 1 / 6371200 m
constexpr float kInv180 = 0x1.6c16c2p-8f;         // 1 / 180

struct Args {
  const float* lat;
  const float* lon;
  const float* alt;
  const uint8_t* inside;  // or NULL
  const float4* coef;     // [degree][NPP / 4]
  const float4* ceff;     // [nrec][2][NP][KQ]
  float* out;             // [nrec][npts]
  long long npts;
  int nrec, degree;
  int vec;  // lat/lon/alt/out PT-aligned and npts % PT == 0
  float theta_c, inv_half, kx, ky, ct0, st0;
};

// PT values of src from index i0: one vector load, or clamped scalar loads
// at the ragged end (the clamped copies are computed and never stored).
__device__ __forceinline__ void load_group(const float* src, long long i0,
                                           long long npts, bool vec,
                                           float (&v)[PT]) {
  if (vec) {
    if constexpr (PT == 2) {
      const float2 x = *reinterpret_cast<const float2*>(src + i0);
      v[0] = x.x; v[1] = x.y;
    } else {
      v[0] = src[i0];
    }
  } else {
#pragma unroll
    for (int p = 0; p < PT; ++p)
      v[p] = src[i0 + p < npts ? i0 + p : npts - 1];
  }
}

// dst points at element i0 of an output row.
__device__ __forceinline__ void store_group(float* dst, long long i0,
                                            long long npts, bool vec,
                                            const float (&v)[PT]) {
  if (vec) {
    if constexpr (PT == 2)
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    else
      dst[0] = v[0];
  } else {
#pragma unroll
    for (int p = 0; p < PT; ++p)
      if (i0 + p < npts) dst[p] = v[p];
  }
}

// An opaque definition: the value stays in a register as computed.  Without
// it ptxas sinks the products P_j cos(m phi), P_j sin(m phi) and
// e^{-z/2} L_k into the record loop and forms them again for every record.
__device__ __forceinline__ void keep(float& x) { asm("" : "+f"(x)); }

__device__ __forceinline__ float comp(const float4& c, int e) {
  return e == 0 ? c.x : e == 1 ? c.y : e == 2 ? c.z : c.w;
}

// VI_MINBLOCKS = 2 caps a thread at 128 registers so that two blocks fit
// an SM; kernel_config asks for it while PT points' live state fits.
__global__ void __launch_bounds__(kThreads, VI_MINBLOCKS)
grid_eval_kernel(Args a) {
  extern __shared__ float4 smem[];
  const int ncoef4 = a.degree * (NPP / 4);
  const int n4 = ncoef4 + a.nrec * 2 * NP * KQ;
  for (int t = threadIdx.x; t < n4; t += kThreads)
    smem[t] = t < ncoef4 ? a.coef[t] : a.ceff[t - ncoef4];
  __syncthreads();
  const float4* s_coef = smem;
  const float4* s_ceff = smem + ncoef4;

  const bool vec = a.vec != 0;
  const float kNaN = __int_as_float(0x7fc00000);
  const float omc = 1.f - a.ct0;
  const long long ngroups = (a.npts + PT - 1) / PT;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < ngroups; g += (long long)gridDim.x * kThreads) {
    const long long i0 = g * PT;
    // the mask first: a group the FoV leaves out skips the transform
    bool nan[PT];
    bool live = false;
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      nan[p] = a.inside && !a.inside[i0 + p < a.npts ? i0 + p : a.npts - 1];
      live |= !nan[p];
    }
    float u[PT], zt[PT], c1[PT], s1[PT];
    if (live) {
      float lat[PT], lon[PT], alt[PT];
      load_group(a.lat, i0, a.npts, vec, lat);
      load_group(a.lon, i0, a.npts, vec, lon);
      load_group(a.alt, i0, a.npts, vec, alt);
      live = false;
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        // WGS-84 geodetic -> ECEF
        float sla, cla, slo, clo;
        sincospif(lat[p] * kInv180, &sla, &cla);
        sincospif(lon[p] * kInv180, &slo, &clo);
        const float nrad = kWgs84A / sqrtf(1.f - kWgs84E2 * sla * sla);
        const float rho = (nrad + alt[p]) * cla;
        const float x = rho * clo;
        const float y = rho * slo;
        const float zz = (nrad * kOneMinusE2 + alt[p]) * sla;

        // Rodrigues rotation by +theta0 about k = (kx, ky, 0)
        const float kdv = a.kx * x + a.ky * y;
        const float rx = x * a.ct0 + a.ky * zz * a.st0 + a.kx * kdv * omc;
        const float ry = y * a.ct0 - a.kx * zz * a.st0 + a.ky * kdv * omc;
        const float rz = zz * a.ct0 + (a.kx * y - a.ky * x) * a.st0;

        const float r2h = rx * rx + ry * ry;
        const float rho_h = sqrtf(fmaxf(r2h, 1e-30f));
        const float r = sqrtf(r2h + rz * rz);
        const float theta = atan2f(rho_h, rz);
        zt[p] = 100.f * (r * kInvRE - 1.f);
        c1[p] = rx / rho_h;  // cos/sin phi
        s1[p] = ry / rho_h;

        const float u_raw = (theta - a.theta_c) * a.inv_half;
        nan[p] = nan[p] || fabsf(u_raw) > 1.0001f;
        live |= !nan[p];
        u[p] = fminf(fmaxf(u_raw, -1.f), 1.f);
      }
    }
    if (!live) {
      float o[PT];
#pragma unroll
      for (int p = 0; p < PT; ++p) o[p] = kNaN;
      float* dst = a.out + i0;
      for (int r = 0; r < a.nrec; ++r, dst += a.npts)
        store_group(dst, i0, a.npts, vec, o);
      continue;
    }

    // P_j(u) for all pairs: one T_d recurrence, coef rows shared.  Starting
    // from T_{-1} = T_1 = u, T_0 = 1 the first step gives T_1 = u exactly.
    float P[PT][NP];
#pragma unroll
    for (int q = 0; q < NPP / 4; ++q) {
      const float4 c = s_coef[q];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < NP)
#pragma unroll
          for (int p = 0; p < PT; ++p) P[p][4 * q + e] = comp(c, e);
    }
    {
      float tm1[PT], t[PT], two_u[PT];
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        tm1[p] = u[p];
        t[p] = 1.f;
        two_u[p] = 2.f * u[p];
      }
#pragma unroll 2
      for (int d = 1; d < a.degree; ++d) {
#pragma unroll
        for (int p = 0; p < PT; ++p) {
          const float tn = fmaf(two_u[p], t[p], -tm1[p]);
          tm1[p] = t[p];
          t[p] = tn;
        }
        const float4* row = s_coef + d * (NPP / 4);
#pragma unroll
        for (int q = 0; q < NPP / 4; ++q) {
          const float4 c = row[q];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * q + e < NP)
#pragma unroll
              for (int p = 0; p < PT; ++p)
                P[p][4 * q + e] = fmaf(comp(c, e), t[p], P[p][4 * q + e]);
        }
      }
    }

    // Pc_j = P_j cos(mbar phi) in place, Ps_s = P_j sin(mbar phi) for the
    // mbar > 0 pairs; cos/sin(m phi) by Chebyshev recurrence
    float Ps[PT][NS > 0 ? NS : 1];
    float lagE[PT][MAXKB];
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      float cosm[MAXL], sinm[MAXL];
      cosm[0] = 1.f;
      sinm[0] = 0.f;
      if constexpr (MAXL > 1) {
        cosm[1] = c1[p];
        sinm[1] = s1[p];
      }
#pragma unroll
      for (int m = 2; m < MAXL; ++m) {
        cosm[m] = 2.f * c1[p] * cosm[m - 1] - cosm[m - 2];
        sinm[m] = 2.f * c1[p] * sinm[m - 1] - sinm[m - 2];
      }
#pragma unroll
      for (int l = 1; l < MAXL; ++l)
#pragma unroll
        for (int mb = 1; mb <= l; ++mb) {
          const int j = l * (l + 1) / 2 + mb;
          Ps[p][j - l - 1] = P[p][j] * sinm[mb];
          P[p][j] *= cosm[mb];
          keep(Ps[p][j - l - 1]);
          keep(P[p][j]);
        }

      // e^{-z/2} L_k(z), forward recurrence (rows past maxk meet zero ceff)
      float lag[MAXKB];
      lag[0] = 1.f;
      lag[1] = 1.f - zt[p];
#pragma unroll
      for (int kk = 1; kk < MAXKB - 1; ++kk)
        lag[kk + 1] = ((2.f * kk + 1.f - zt[p]) * lag[kk] - kk * lag[kk - 1]) *
                      (1.f / (kk + 1.f));
      const float ez = expf(-0.5f * zt[p]);
#pragma unroll
      for (int k = 0; k < MAXKB; ++k) {
        lagE[p][k] = lag[k] * ez;
        keep(lagE[p][k]);
      }
    }

    const float4* cr = s_ceff;
    float* dst = a.out + i0;
#pragma unroll 1
    for (int r = 0; r < a.nrec; ++r, cr += 2 * NP * KQ, dst += a.npts) {
      float acc[PT];
#pragma unroll
      for (int p = 0; p < PT; ++p) acc[p] = 0.f;
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        float S[PT][4];
#pragma unroll
        for (int p = 0; p < PT; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) S[p][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const float4 c = cr[j * KQ + kq];
#pragma unroll
          for (int p = 0; p < PT; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              S[p][e] = fmaf(P[p][j], comp(c, e), S[p][e]);
        }
#pragma unroll
        for (int l = 1; l < MAXL; ++l)
#pragma unroll
          for (int mb = 1; mb <= l; ++mb) {
            const int j = l * (l + 1) / 2 + mb;
            const float4 c = cr[(NP + j) * KQ + kq];
#pragma unroll
            for (int p = 0; p < PT; ++p)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                S[p][e] = fmaf(Ps[p][j - l - 1], comp(c, e), S[p][e]);
          }
#pragma unroll
        for (int p = 0; p < PT; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[p] = fmaf(lagE[p][4 * kq + e], S[p][e], acc[p]);
      }
      float o[PT];
#pragma unroll
      for (int p = 0; p < PT; ++p) o[p] = nan[p] ? kNaN : acc[p];
      store_group(dst, i0, a.npts, vec, o);
    }
  }
}

}  // namespace

extern "C" {

// This library's instantiation: {maxl, maxk bucket, points per thread,
// threads per block, min blocks an SM}.
void vi_grid_eval_config(int* out) {
  out[0] = MAXL;
  out[1] = MAXKB;
  out[2] = PT;
  out[3] = kThreads;
  out[4] = VI_MINBLOCKS;
}

// Evaluates nrec records at npts points in one launch; returns a
// cudaError_t value (0 on success).  smem is the launch's dynamic shared
// memory, the packed coef and ceff tables.  Arrays, all 16-byte aligned except
// lat/lon/alt (PT-float aligned when vec != 0) and inside: lat/lon/alt
// [npts] float32 degrees/metres, inside [npts] uint8 or NULL, coef
// [degree][NPP] float32 zero above each pair's degree, ceff
// [nrec][2][NP][MAXKB] float32, out [nrec][npts].  vec != 0 promises
// npts % PT == 0 and PT-float-aligned lat/lon/alt/out.
int vi_grid_eval_records(const float* lat, const float* lon, const float* alt,
                         const uint8_t* inside, const float* coef,
                         const float* ceff, float* out, long long npts,
                         int nrec, int degree, int vec, float theta_c,
                         float inv_half, float kx, float ky, float ct0,
                         float st0, long long smem, void* stream) {
  if (degree < 1 || degree > kMaxDegree || npts < 0 || nrec < 0 || smem < 0)
    return (int)cudaErrorInvalidValue;
  if (npts == 0 || nrec == 0) return 0;
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(grid_eval_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_eval_kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long ngroups = (npts + PT - 1) / PT;
  const long long need = (ngroups + kThreads - 1) / kThreads;
  const long long fit = (long long)per_sm * nsm;
  Args a{lat, lon, alt, inside,
         reinterpret_cast<const float4*>(coef),
         reinterpret_cast<const float4*>(ceff),
         out, npts, nrec, degree, vec, theta_c, inv_half, kx, ky, ct0, st0};
  grid_eval_kernel<<<(unsigned)(need < fit ? need : fit), kThreads,
                     (size_t)smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* vi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
