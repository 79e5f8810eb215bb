// Fused dense-grid evaluation of the sphharmlag model on Hopper (sm_90a).
//
// Replaces the TPU kernel volumetricinterp_tpu/ops/grid_eval_pallas.py::_kernel
// (launched by eval_records_latlonalt_pallas).  For every grid point and
// every record of a batch it computes
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
// What bounds it on an H100: per point about 2 sum_j deg_j FMAs for the
// pair series (~600 at nbasis = 144 on the benchmark band) and ~10
// transcendentals, then ~npairs (2 maxk + 2) FMAs per record, against 12
// bytes in (13 with the FoV mask) and 4 nrec bytes out: ~100 flop/byte at
// nrec = 8, far above the card's ~20 flop/byte float32 balance, so it is
// compute-bound.  The design amortises the record-independent work: one
// thread per point computes the transform, the trig and Laguerre rows and
// all P_j(u) once (P in registers, the loops over pairs unrolled at
// compile time, T_d carried as a two-term recurrence), then loops over the
// launch's records, where only the radial contraction and the pair sum read
// ceff.  The Pallas grid recomputed everything per record.  coef, the pair
// degrees and the records' ceff sit in shared memory (read as warp-wide
// broadcasts); stores out[r * npts + i] are coalesced.  No padding: the
// ragged edge is masked here.
//
// Accuracy: libdevice sinf/cosf/sqrtf/atan2f/expf with IEEE division
// (built without --use_fast_math).  The error envelope is set by float32
// theta resolution (~1e-7 rad times dP/dtheta ~ nu), ~5e-5 of the sup for
// coefficients of one scale; a fitted record whose terms cancel ~1e3-fold
// (sub-cutoff coefficient directions) sits at float32 rounding of its gross
// sum sum_n |C_n B_n|, as the TPU kernel does.
//
// Caps (compile-time): maxl <= 10 (npairs <= 55), maxk <= 16,
// degree <= 256.  The Python wrapper checks them before launching.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxL = 10;
constexpr int kMaxK = 16;
constexpr int kMaxDegree = 256;
constexpr int kThreads = 256;
constexpr int kSmemBudget = 160 * 1024;  // of the 227 KB a block may use

// float32 roundings of the constants (volumetricinterp_tpu_torch/constants.py)
constexpr float kWgs84A = 0x1.854a64p+22f;        // 6378137 m
constexpr float kWgs84E2 = 0x1.b6b91p-8f;         // first eccentricity^2
constexpr float kOneMinusE2 = 0x1.fc928ep-1f;     // 1 - e^2
constexpr float kInvRE = 0x1.510fa4p-23f;         // 1 / 6371200 m
constexpr float kDeg2Rad = 0x1.1df46ap-6f;        // pi / 180

struct Args {
  const float* lat;
  const float* lon;
  const float* alt;
  const uint8_t* inside;
  const float* coef;
  const int* pair_deg;
  const float* ceff;
  float* out;
  long long npts;
  int nrec, degree, maxl, maxk;
  float theta_c, inv_half, kx, ky, ct0, st0;
  cudaStream_t stream;
};

template <int MAXL, int MAXK>
__global__ void __launch_bounds__(kThreads)
grid_eval_kernel(Args a, int nrec) {
  constexpr int NP = MAXL * (MAXL + 1) / 2;
  extern __shared__ float smem[];
  float* s_coef = smem;                        // [degree, NP]
  float* s_ceff = smem + a.degree * NP;        // [nrec, 2, NP, MAXK]
  int* s_deg = reinterpret_cast<int*>(s_ceff + nrec * 2 * NP * MAXK);

  for (int t = threadIdx.x; t < a.degree * NP; t += blockDim.x)
    s_coef[t] = a.coef[t];
  for (int t = threadIdx.x; t < nrec * 2 * NP * MAXK; t += blockDim.x) {
    const int k = t % MAXK;
    s_ceff[t] = k < a.maxk ? a.ceff[(t / MAXK) * a.maxk + k] : 0.f;
  }
  for (int t = threadIdx.x; t < NP; t += blockDim.x) s_deg[t] = a.pair_deg[t];
  __syncthreads();

  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= a.npts) return;

  // WGS-84 geodetic -> ECEF
  float sla, cla, slo, clo;
  sincosf(a.lat[i] * kDeg2Rad, &sla, &cla);
  sincosf(a.lon[i] * kDeg2Rad, &slo, &clo);
  const float alt = a.alt[i];
  const float nrad = kWgs84A / sqrtf(1.f - kWgs84E2 * sla * sla);
  const float rho = (nrad + alt) * cla;
  const float x = rho * clo;
  const float y = rho * slo;
  const float zz = (nrad * kOneMinusE2 + alt) * sla;

  // Rodrigues rotation by +theta0 about k = (kx, ky, 0)
  const float kdv = a.kx * x + a.ky * y;
  const float omc = 1.f - a.ct0;
  const float rx = x * a.ct0 + a.ky * zz * a.st0 + a.kx * kdv * omc;
  const float ry = y * a.ct0 - a.kx * zz * a.st0 + a.ky * kdv * omc;
  const float rz = zz * a.ct0 + (a.kx * y - a.ky * x) * a.st0;

  const float r2h = rx * rx + ry * ry;
  const float rho_h = sqrtf(fmaxf(r2h, 1e-30f));
  const float r = sqrtf(r2h + rz * rz);
  const float theta = atan2f(rho_h, rz);
  const float zt = 100.f * (r * kInvRE - 1.f);

  const float u_raw = (theta - a.theta_c) * a.inv_half;
  const bool masked = fabsf(u_raw) > 1.0001f || (a.inside && !a.inside[i]);
  if (masked) {
    for (int rr = 0; rr < nrec; ++rr) a.out[rr * a.npts + i] = __int_as_float(0x7fc00000);
    return;
  }
  const float u = fminf(fmaxf(u_raw, -1.f), 1.f);
  const float two_u = 2.f * u;

  // cos/sin(m phi) by Chebyshev recurrence from cos/sin phi = rx/rho, ry/rho
  const float c1 = rx / rho_h;
  const float s1 = ry / rho_h;
  float cosm[MAXL], sinm[MAXL];
  cosm[0] = 1.f;
  sinm[0] = 0.f;
  if constexpr (MAXL > 1) {
    cosm[1] = c1;
    sinm[1] = s1;
  }
#pragma unroll
  for (int m = 2; m < MAXL; ++m) {
    cosm[m] = 2.f * c1 * cosm[m - 1] - cosm[m - 2];
    sinm[m] = 2.f * c1 * sinm[m - 1] - sinm[m - 2];
  }

  // Laguerre rows L_k(z), forward recurrence (rows past maxk meet zero ceff)
  float lag[MAXK];
  lag[0] = 1.f;
  if constexpr (MAXK > 1) lag[1] = 1.f - zt;
#pragma unroll
  for (int kk = 1; kk < MAXK - 1; ++kk)
    lag[kk + 1] = ((2.f * kk + 1.f - zt) * lag[kk] - kk * lag[kk - 1]) * (1.f / (kk + 1.f));

  // P_j(u) at each pair's own degree, T_d by two-term recurrence
  float P[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int deg = s_deg[j];
    float p = s_coef[j];
    if (deg > 1) {
      float tm1 = 1.f, t = u;
      p = fmaf(s_coef[NP + j], u, p);
      for (int d = 2; d < deg; ++d) {
        const float tn = fmaf(two_u, t, -tm1);
        tm1 = t;
        t = tn;
        p = fmaf(s_coef[d * NP + j], tn, p);
      }
    }
    P[j] = p;
  }

  const float ez = expf(-0.5f * zt);
  for (int rr = 0; rr < nrec; ++rr) {
    const float* cr = s_ceff + rr * 2 * NP * MAXK;
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < MAXL; ++l) {
#pragma unroll
      for (int mb = 0; mb <= l; ++mb) {
        const int j = l * (l + 1) / 2 + mb;
        float rc = 0.f;
#pragma unroll
        for (int k = 0; k < MAXK; ++k) rc = fmaf(cr[j * MAXK + k], lag[k], rc);
        if (mb == 0) {
          acc = fmaf(P[j], rc, acc);  // the sin branch is identically zero
        } else {
          float rs = 0.f;
#pragma unroll
          for (int k = 0; k < MAXK; ++k)
            rs = fmaf(cr[(NP + j) * MAXK + k], lag[k], rs);
          acc = fmaf(P[j], cosm[mb] * rc + sinm[mb] * rs, acc);
        }
      }
    }
    a.out[rr * a.npts + i] = acc * ez;
  }
}

template <int MAXL, int MAXK>
int launch(const Args& a) {
  constexpr int NP = MAXL * (MAXL + 1) / 2;
  const int base = a.degree * NP * 4 + NP * 4;
  const int per_rec = 2 * NP * MAXK * 4;
  int rpl = (kSmemBudget - base) / per_rec;
  if (rpl < 1) rpl = 1;
  const unsigned blocks = (unsigned)((a.npts + kThreads - 1) / kThreads);
  for (int r0 = 0; r0 < a.nrec; r0 += rpl) {
    const int n = a.nrec - r0 < rpl ? a.nrec - r0 : rpl;
    const int smem = base + n * per_rec;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          grid_eval_kernel<MAXL, MAXK>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    Args b = a;
    b.ceff = a.ceff + (long long)r0 * 2 * NP * a.maxk;
    b.out = a.out + (long long)r0 * a.npts;
    grid_eval_kernel<MAXL, MAXK><<<blocks, kThreads, smem, a.stream>>>(b, n);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

template <int MAXL>
int launch_k(const Args& a) {
  if (a.maxk <= 4) return launch<MAXL, 4>(a);
  if (a.maxk <= 8) return launch<MAXL, 8>(a);
  return launch<MAXL, 16>(a);
}

}  // namespace

extern "C" {

// Evaluates nrec records at npts points; returns a cudaError_t value
// (0 on success).  Arrays: lat/lon/alt [npts] float32 degrees/metres,
// inside [npts] uint8 or NULL, coef [degree, npairs] float32, pair_deg
// [npairs] int32, ceff [nrec, 2, npairs, maxk] float32, out [nrec, npts].
int vi_grid_eval_records(const float* lat, const float* lon, const float* alt,
                         const uint8_t* inside, const float* coef,
                         const int* pair_deg, const float* ceff, float* out,
                         long long npts, int nrec, int degree, int maxl,
                         int maxk, float theta_c, float inv_half, float kx,
                         float ky, float ct0, float st0, void* stream) {
  if (maxl < 1 || maxl > kMaxL || maxk < 1 || maxk > kMaxK || degree < 1 ||
      degree > kMaxDegree || npts < 0 || nrec < 0)
    return (int)cudaErrorInvalidValue;
  if (npts == 0 || nrec == 0) return 0;
  Args a{lat, lon, alt, inside, coef, pair_deg, ceff, out, npts, nrec,
         degree, maxl, maxk, theta_c, inv_half, kx, ky, ct0, st0,
         static_cast<cudaStream_t>(stream)};
  switch (maxl) {
    case 1: return launch_k<1>(a);
    case 2: return launch_k<2>(a);
    case 3: return launch_k<3>(a);
    case 4: return launch_k<4>(a);
    case 5: return launch_k<5>(a);
    case 6: return launch_k<6>(a);
    case 7: return launch_k<7>(a);
    case 8: return launch_k<8>(a);
    case 9: return launch_k<9>(a);
    default: return launch_k<10>(a);
  }
}

const char* vi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
