// Seeded image watershed (hop-tie claim recurrence) for NVIDIA Hopper,
// sm_90a.
//
// Replaces the TPU kernel iterseg_tpu/ops/pallas_flood.py:_image_flood_kernel
// (driven by pallas_image_flood_jit). The flood rule is the image recurrence
// of iterseg_tpu_torch/ops/device_flood.py, skimage's node-keyed heap rule
// watershed(values, markers, mask) on the DoG path's -EDT: a free voxel u
// (in the mask, not a seed) takes the labelled face neighbour v with the
// smallest key (d_v, h_v, idx_v) and claims only if that key is strictly
// below its stored claimant key (ckd_u, ckh_u, cki_u); then
// d_u = max(d_v, values[u]), lab_u = lab_v, and the hop count h_u is 0 when
// that max rose strictly above d_v, else h_v + 1. Seeds start at their own
// value with h = 0 and claimant key -inf, and never change.
//
// Tie order: idx is the row-major ravel index of the (Z, Y, X) volume the
// caller passes, as in the JAX recurrence.
//
// Schedule: that of affinity_flood.cu. CTAs run in no order, so the state
// (d, lab, h, ckd, ckh, cki) is double-buffered (A -> B) and every launch is
// deterministic:
//  * one CTA per (TZ, TY, TX) = (4, 8, 32) tile, one thread per voxel;
//  * the CTA loads d, lab and h of the tile plus a 1-voxel halo from A into
//    shared memory; each thread keeps its voxel's claimant key, code and
//    value in registers;
//  * it applies the rule up to inner_cap times to the interior only
//    (Jacobi inside the tile, halo frozen, a barrier between steps) and
//    writes the free voxels' state to B;
//  * flags[launch] is set when any voxel of any tile claimed; the host swaps
//    A and B and relaunches until a flag stays 0. A launch that finds
//    flags[launch - 1] == 0 returns at once (B already equals A).
// With inner_cap = 1 a launch is exactly one step of the synchronous
// recurrence, so the labels equal JAX wavefront_image_flood_jit(mode=
// "claim") bit for bit. The hop reset compares max(d_v, value) > d_v in f32
// with IEEE semantics: build without --use_fast_math.
//
// Bound: memory. Per voxel and launch the kernel reads d, lab and h through
// the shared tile (each word once per CTA, halo overhead (6*10*34) /
// (4*8*32) = 2x), code, and for free voxels ckd, ckh, cki and the value;
// claiming voxels write 6 words. That is a few dozen compares per voxel
// against ~50 bytes, so it sits far below the card's operations per byte.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TZ = 4, TY = 8, TX = 32;

struct Best {
  float kd;
  int kh;
  int ki;
  int lab;
};

__device__ __forceinline__ void consider(Best& b, float d_v, int lab_v,
                                         int h_v, int idx_v) {
  bool better =
      lab_v > 0 &&
      (d_v < b.kd ||
       (d_v == b.kd && (h_v < b.kh || (h_v == b.kh && idx_v < b.ki))));
  if (better) {
    b.kd = d_v;
    b.kh = h_v;
    b.ki = idx_v;
    b.lab = lab_v;
  }
}

__global__ void __launch_bounds__(TZ * TY * TX)
image_flood_step(const float* __restrict__ d_in,
                 const int* __restrict__ lab_in,
                 const int* __restrict__ h_in,
                 const float* __restrict__ ckd_in,
                 const int* __restrict__ ckh_in,
                 const int* __restrict__ cki_in, float* __restrict__ d_out,
                 int* __restrict__ lab_out, int* __restrict__ h_out,
                 float* __restrict__ ckd_out, int* __restrict__ ckh_out,
                 int* __restrict__ cki_out, const uint8_t* __restrict__ code,
                 const float* __restrict__ values, int Z, int Y, int X,
                 int inner_cap, int* __restrict__ flags, int launch) {
  if (flags[launch - 1] == 0) return;  // converged: B already equals A

  __shared__ float s_d[TZ + 2][TY + 2][TX + 2];
  __shared__ int s_lab[TZ + 2][TY + 2][TX + 2];
  __shared__ int s_h[TZ + 2][TY + 2][TX + 2];

  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  const int tid = tx + TX * (ty + TY * tz);
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, z0 = blockIdx.z * TZ;
  const long long YX = (long long)Y * X;

  constexpr int HALO = (TZ + 2) * (TY + 2) * (TX + 2);
  for (int i = tid; i < HALO; i += TZ * TY * TX) {
    const int lx = i % (TX + 2);
    const int ly = (i / (TX + 2)) % (TY + 2);
    const int lz = i / ((TX + 2) * (TY + 2));
    const int gx = x0 + lx - 1, gy = y0 + ly - 1, gz = z0 + lz - 1;
    const bool in = gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 &&
                    gz < Z;
    const long long g = (gz * (long long)Y + gy) * X + gx;
    s_d[lz][ly][lx] = in ? d_in[g] : INFINITY;
    s_lab[lz][ly][lx] = in ? lab_in[g] : 0;
    s_h[lz][ly][lx] = in ? h_in[g] : 0;
  }

  const int gx = x0 + tx, gy = y0 + ty, gz = z0 + tz;
  const bool in = gx < X && gy < Y && gz < Z;
  const long long g = (gz * (long long)Y + gy) * X + gx;
  const bool is_free = in && code[g] == 1;
  float ckd = INFINITY, val = 0.0f;
  int ckh = 0, cki = 0;
  const int idx = (int)g;
  if (is_free) {
    ckd = ckd_in[g];
    ckh = ckh_in[g];
    cki = cki_in[g];
    val = values[g];
  }
  __syncthreads();

  const int lz = tz + 1, ly = ty + 1, lx = tx + 1;
  bool claimed_any = false;
  for (int it = 0; it < inner_cap; ++it) {
    bool claim = false;
    Best b{INFINITY, 0, 0, 0};
    if (is_free) {
      consider(b, s_d[lz - 1][ly][lx], s_lab[lz - 1][ly][lx],
               s_h[lz - 1][ly][lx], idx - (int)YX);
      consider(b, s_d[lz + 1][ly][lx], s_lab[lz + 1][ly][lx],
               s_h[lz + 1][ly][lx], idx + (int)YX);
      consider(b, s_d[lz][ly - 1][lx], s_lab[lz][ly - 1][lx],
               s_h[lz][ly - 1][lx], idx - X);
      consider(b, s_d[lz][ly + 1][lx], s_lab[lz][ly + 1][lx],
               s_h[lz][ly + 1][lx], idx + X);
      consider(b, s_d[lz][ly][lx - 1], s_lab[lz][ly][lx - 1],
               s_h[lz][ly][lx - 1], idx - 1);
      consider(b, s_d[lz][ly][lx + 1], s_lab[lz][ly][lx + 1],
               s_h[lz][ly][lx + 1], idx + 1);
      claim = b.kd < ckd ||
              (b.kd == ckd && (b.kh < ckh || (b.kh == ckh && b.ki < cki)));
    }
    // every thread has read its neighbours before any writes its own voxel
    const int any = __syncthreads_or(claim);
    if (claim) {
      // torch.maximum semantics: NaN propagates
      const float d_new =
          (isnan(b.kd) || isnan(val)) ? NAN : fmaxf(b.kd, val);
      s_d[lz][ly][lx] = d_new;
      s_lab[lz][ly][lx] = b.lab;
      s_h[lz][ly][lx] = d_new > b.kd ? 0 : b.kh + 1;
      ckd = b.kd;
      ckh = b.kh;
      cki = b.ki;
    }
    if (!any) break;
    claimed_any = true;
    __syncthreads();
  }

  if (is_free) {
    d_out[g] = s_d[lz][ly][lx];
    lab_out[g] = s_lab[lz][ly][lx];
    h_out[g] = s_h[lz][ly][lx];
    ckd_out[g] = ckd;
    ckh_out[g] = ckh;
    cki_out[g] = cki;
  }
  if (claimed_any && tid == 0) flags[launch] = 1;
}

}  // namespace

extern "C" {

// One launch of the image flood on `stream`: reads state A, writes state B,
// reads flags[launch - 1] and sets flags[launch] when anything claimed.
// Returns cudaGetLastError() of the launch (0 on success).
int image_flood_launch(const float* d_in, const int* lab_in, const int* h_in,
                       const float* ckd_in, const int* ckh_in,
                       const int* cki_in, float* d_out, int* lab_out,
                       int* h_out, float* ckd_out, int* ckh_out, int* cki_out,
                       const uint8_t* code, const float* values, int Z, int Y,
                       int X, int inner_cap, int* flags, int launch,
                       void* stream) {
  dim3 block(TX, TY, TZ);
  dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, (Z + TZ - 1) / TZ);
  image_flood_step<<<grid, block, 0, (cudaStream_t)stream>>>(
      d_in, lab_in, h_in, ckd_in, ckh_in, cki_in, d_out, lab_out, h_out,
      ckd_out, ckh_out, cki_out, code, values, Z, Y, X, inner_cap, flags,
      launch);
  return (int)cudaGetLastError();
}

// The kernel's tile shape, so the plain version can reproduce its schedule.
void image_flood_tile(int* tz, int* ty, int* tx) {
  *tz = TZ;
  *ty = TY;
  *tx = TX;
}

}  // extern "C"
