// Seeded affinity flood (claim recurrence) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel iterseg_tpu/ops/pallas_flood.py:_flood_kernel
// (driven by pallas_flood_jit). The flood rule is the claim recurrence of
// iterseg_tpu_torch/ops/device_flood.py: a free voxel u (in the mask, not a
// seed) takes the labelled face neighbour v with the smallest key
// (d_v, idx_v) and claims only if that key is strictly below its stored
// claimant key (ckd_u, cki_u); then d_u = max(d_v, w_uv), lab_u = lab_v.
// The weight crossing between p and p + e_a is aff[a][p + e_a].
//
// Tie order: idx is the row-major ravel index of the (Z, Y, X) volume the
// caller passes. Every row-major embedding orders voxels alike, so ties
// break as in the JAX recurrence and the Pallas kernel.
//
// Schedule. TPU grids run in order, and the Pallas kernel's cross-tile
// Gauss-Seidel sweep relies on it; CTAs here run in no order. So the state
// is double-buffered (A -> B) and every launch is deterministic:
//  * one CTA per (TZ, TY, TX) = (4, 8, 32) tile, one thread per voxel;
//  * the CTA loads d and lab of the tile plus a 1-voxel halo from A into
//    shared memory; each thread keeps its own voxel's claimant key, code
//    and six entering weights in registers;
//  * it applies the claim rule up to inner_cap times to the interior only
//    (Jacobi inside the tile, halo frozen, a barrier between steps) and
//    writes the free voxels' state to B;
//  * flags[launch] is set when any voxel of any tile claimed; the host
//    swaps A and B and relaunches until a flag stays 0.
// With inner_cap = 1 a launch is exactly one step of the synchronous
// recurrence, so the labels equal JAX wavefront_flood_jit(mode="claim")
// bit for bit. Voxels that are not free never change, so both buffers hold
// them from the start and the kernel never rewrites them.
//
// After a launch that claimed nothing, B equals A; a launch that finds
// flags[launch - 1] == 0 therefore returns at once, which lets the host
// queue several launches between reads of the flags.
//
// Bound: memory. Per free voxel and launch the kernel reads d, lab
// (through the shared tile), ckd, cki, code and the entering affinities,
// and writes d, lab, ckd, cki: about 7 words read and 4 written, against a
// few dozen integer and float compares. The shared tile loads each d and lab
// once per CTA instead of once per neighbour (halo overhead (6*10*34) /
// (4*8*32) = 2x on the two arrays), and threads along x read consecutive
// words.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TZ = 4, TY = 8, TX = 32;

struct Best {
  float kd;
  int ki;
  int lab;
  float w;
};

__device__ __forceinline__ void consider(Best& b, float d_v, int lab_v,
                                         float w, int idx_v) {
  bool better = lab_v > 0 &&
                (d_v < b.kd || (d_v == b.kd && idx_v < b.ki));
  if (better) {
    b.kd = d_v;
    b.ki = idx_v;
    b.lab = lab_v;
    b.w = w;
  }
}

__global__ void __launch_bounds__(TZ * TY * TX)
flood_step(const float* __restrict__ d_in, const int* __restrict__ lab_in,
           const float* __restrict__ ckd_in, const int* __restrict__ cki_in,
           float* __restrict__ d_out, int* __restrict__ lab_out,
           float* __restrict__ ckd_out, int* __restrict__ cki_out,
           const uint8_t* __restrict__ code, const float* __restrict__ aff,
           int Z, int Y, int X, int inner_cap, int* __restrict__ flags,
           int launch) {
  if (flags[launch - 1] == 0) return;  // converged: B already equals A

  __shared__ float s_d[TZ + 2][TY + 2][TX + 2];
  __shared__ int s_lab[TZ + 2][TY + 2][TX + 2];

  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  const int tid = tx + TX * (ty + TY * tz);
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, z0 = blockIdx.z * TZ;
  const long long YX = (long long)Y * X;
  const long long N = YX * Z;

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
  }

  const int gx = x0 + tx, gy = y0 + ty, gz = z0 + tz;
  const bool in = gx < X && gy < Y && gz < Z;
  const long long g = (gz * (long long)Y + gy) * X + gx;
  const bool is_free = in && code[g] == 1;
  float ckd = INFINITY, w[6];
  int cki = 0;
  const int idx = (int)g;
  if (is_free) {
    ckd = ckd_in[g];
    cki = cki_in[g];
    w[0] = aff[g];                                   // z-: aff[0] at u
    w[1] = gz + 1 < Z ? aff[g + YX] : INFINITY;      // z+: aff[0] at u+ez
    w[2] = aff[N + g];                               // y-: aff[1] at u
    w[3] = gy + 1 < Y ? aff[N + g + X] : INFINITY;   // y+: aff[1] at u+ey
    w[4] = aff[2 * N + g];                           // x-: aff[2] at u
    w[5] = gx + 1 < X ? aff[2 * N + g + 1] : INFINITY;  // x+: aff[2] at u+ex
  }
  __syncthreads();

  const int lz = tz + 1, ly = ty + 1, lx = tx + 1;
  bool claimed_any = false;
  for (int it = 0; it < inner_cap; ++it) {
    bool claim = false;
    Best b{INFINITY, 0, 0, 0.0f};
    if (is_free) {
      consider(b, s_d[lz - 1][ly][lx], s_lab[lz - 1][ly][lx], w[0],
               idx - (int)YX);
      consider(b, s_d[lz + 1][ly][lx], s_lab[lz + 1][ly][lx], w[1],
               idx + (int)YX);
      consider(b, s_d[lz][ly - 1][lx], s_lab[lz][ly - 1][lx], w[2], idx - X);
      consider(b, s_d[lz][ly + 1][lx], s_lab[lz][ly + 1][lx], w[3], idx + X);
      consider(b, s_d[lz][ly][lx - 1], s_lab[lz][ly][lx - 1], w[4], idx - 1);
      consider(b, s_d[lz][ly][lx + 1], s_lab[lz][ly][lx + 1], w[5], idx + 1);
      claim = b.kd < ckd || (b.kd == ckd && b.ki < cki);
    }
    // every thread has read its neighbours before any writes its own voxel
    const int any = __syncthreads_or(claim);
    if (claim) {
      // torch.maximum semantics: NaN propagates
      s_d[lz][ly][lx] = (isnan(b.kd) || isnan(b.w)) ? NAN : fmaxf(b.kd, b.w);
      s_lab[lz][ly][lx] = b.lab;
      ckd = b.kd;
      cki = b.ki;
    }
    if (!any) break;
    claimed_any = true;
    __syncthreads();
  }

  if (is_free) {
    d_out[g] = s_d[lz][ly][lx];
    lab_out[g] = s_lab[lz][ly][lx];
    ckd_out[g] = ckd;
    cki_out[g] = cki;
  }
  if (claimed_any && tid == 0) flags[launch] = 1;
}

}  // namespace

extern "C" {

// One launch of the flood on `stream`: reads state A, writes state B,
// reads flags[launch - 1] and sets flags[launch] when anything claimed.
// Returns cudaGetLastError() of the launch (0 on success).
int affinity_flood_launch(const float* d_in, const int* lab_in,
                          const float* ckd_in, const int* cki_in,
                          float* d_out, int* lab_out, float* ckd_out,
                          int* cki_out, const uint8_t* code, const float* aff,
                          int Z, int Y, int X, int inner_cap, int* flags,
                          int launch, void* stream) {
  dim3 block(TX, TY, TZ);
  dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, (Z + TZ - 1) / TZ);
  flood_step<<<grid, block, 0, (cudaStream_t)stream>>>(
      d_in, lab_in, ckd_in, cki_in, d_out, lab_out, ckd_out, cki_out, code,
      aff, Z, Y, X, inner_cap, flags, launch);
  return (int)cudaGetLastError();
}

// The kernel's tile shape, so the plain version can reproduce its schedule.
void affinity_flood_tile(int* tz, int* ty, int* tx) {
  *tz = TZ;
  *ty = TY;
  *tx = TX;
}

}  // extern "C"
