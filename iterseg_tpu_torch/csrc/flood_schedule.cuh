// Frontier schedule of the seeded floods on NVIDIA Hopper, sm_90a, shared
// by affinity_flood.cu and image_flood.cu. Each of those keeps only its
// state layout and its claim rule (a `Rule` struct, below) and includes this
// header; the tiling, the worklists, the persistent launch and the host
// launchers are here.
//
// What bounds a flood. The synchronous claim recurrence needs as many steps
// as the longest geodesic path to a seed (43-48 on the DoG and affinity
// paths' (35, 514, 514) grids), yet only 2-3% of the grid is free and most
// of it settles within a few steps: sweeping the whole grid on every step
// would move ~17-25 B a voxel per step for voxels that cannot change, and a
// launch per step would pay a launch and a host round trip each time. So
// the flood is bounded by the tiles it visits (their loads are chains of
// dependent memory round trips) and by the number of steps, not by its
// arithmetic.
//
// What the schedule does about it.
//  * Tiles. The grid is cut into (TZ, TY, TX) = (2, 8, 32) tiles, one
//    thread per voxel, x innermost so that a warp reads 32 consecutive
//    words. A tile loads the halo'd words of the rule (d and lab, and h for
//    the image flood) from buffer src into shared memory, keeps its voxels'
//    own state in registers, runs up to inner_cap Jacobi steps of the claim
//    rule on its interior with the halo frozen (a barrier between steps),
//    and writes its free voxels to buffer dst.
//  * Double buffer. Step k reads buffer (k - 1) % 2 and writes buffer k % 2,
//    so no tile reads what another tile writes in the same step, and the
//    labels do not depend on the order in which tiles run.
//  * Frontier. Step k processes only the tiles on worklist k. The init
//    kernel puts every tile that holds a free voxel on list 1. A tile that
//    claimed anything at step k puts itself on list k + 1, and the face
//    neighbour across each of its 6 faces whose boundary layer holds a
//    voxel that claimed, keeping only tiles that hold a free voxel; a
//    per-tile stamp (atomicMax(&stamp[t], k + 1)) removes duplicates and
//    atomicAdd on the list's count appends. The claim rule reads only face
//    neighbours, so the halo words a tile reads are its face neighbours'
//    boundary layers facing it.
//  * Why skipping is exact. A tile's step is a function of its own state
//    and its halo in src. Take a tile T left off list k and the last step
//    j < k at which it ran (or the init kernel, if it never ran). At step j
//    it claimed nothing, or it would be on list j + 1; so it wrote src to
//    dst unchanged, and its two buffers have been equal since. No voxel of
//    a face neighbour's layer facing T claimed at any step in [j, k), or T
//    would be on a list after j; so those layers, T's halo, hold what they
//    held at step j. So T's state and halo at step k are those of step j,
//    where it claimed nothing: it would claim nothing at step k either, and
//    buffer dst already holds its state. Voxels that are not free never
//    change, and the init kernel writes them into both buffers.
//  * One persistent launch. The step kernel is launched once per flood with
//    cudaLaunchCooperativeKernel, at most as many CTAs as can be resident
//    at once (SMs x occupancy, and no more than there are tiles). Each CTA
//    grid-strides over the current list; steps are separated by
//    cooperative_groups grid syncs. The flood has converged when the next
//    list is empty, or stops at max_steps; the host reads steps, converged
//    and tile_steps (tiles processed, summed over steps) once, at the end.
//    Three lists rotate: during step k, CTA 0 resets the count of list
//    k + 2 (the list of step k - 1, which every CTA finished reading before
//    the last barrier) so that it is zero before the barrier that ends
//    step k, after which step k + 1 appends to it.
//  * Memory ordering. State, lists and counts are written by other CTAs
//    within the same launch, so they are read with ld.global.cg (L2, never
//    a stale L1 line) and never through the read-only path; only the code,
//    the inputs and has_free, which no step writes, are read through it.
//
// Each run's labels and step count equal those of a sweep of every tile on
// every step (the plain version, ops/flood_kernel.run_tiled), and with
// inner_cap = 1 those of the synchronous recurrence.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flood {

namespace cg = cooperative_groups;

constexpr int TZ = 2, TY = 8, TX = 32;
constexpr int kThreads = TZ * TY * TX;
constexpr int HZ = TZ + 2, HY = TY + 2, HX = TX + 2;
constexpr int kHalo = HZ * HY * HX;
// CTAs of the step kernel resident on one SM: 2 leaves each thread 64
// registers, which the rule's registers and the tile's indices need; a
// tighter cap spills.
constexpr int kStepBlocksPerSM = 2;

// One state word of a halo'd tile in shared memory; floats are kept as
// their bits.
typedef int Tile[HZ][HY][HX];

// Word 0 of every rule's state is d, filled with +inf outside the volume;
// the other halo words (lab, h) are 0 there.
__device__ __forceinline__ int halo_fill(int word) {
  return word == 0 ? __float_as_int(INFINITY) : 0;
}

// The volume's tiling and the work area: the counts of the three rotating
// worklists, the three lists, and a stamp and a has-free flag per tile, all
// int words (3 + 5 * n_tiles of them).
struct Schedule {
  int Z, Y, X;
  int nz, ny, nx, n_tiles;
  int* counts;
  int* lists;
  int* stamp;
  int* has_free;
};

inline Schedule make_schedule(int Z, int Y, int X, int* work) {
  Schedule s;
  s.Z = Z;
  s.Y = Y;
  s.X = X;
  s.nz = (Z + TZ - 1) / TZ;
  s.ny = (Y + TY - 1) / TY;
  s.nx = (X + TX - 1) / TX;
  s.n_tiles = s.nz * s.ny * s.nx;
  s.counts = work;
  s.lists = work + 3;
  s.stamp = s.lists + 3 * s.n_tiles;
  s.has_free = s.stamp + s.n_tiles;
  return s;
}

// This thread's voxel of tile t: (lz, ly, lx) in the halo'd tile, g its
// row-major index in the volume.
struct Voxel {
  int gz, gy, gx, lz, ly, lx;
  long long g;
  bool in;
};

__device__ __forceinline__ Voxel voxel_of(const Schedule& s, int t) {
  const int tid = threadIdx.x;
  Voxel v;
  v.lx = tid % TX + 1;
  v.ly = (tid / TX) % TY + 1;
  v.lz = tid / (TX * TY) + 1;
  v.gz = (t / (s.ny * s.nx)) * TZ + v.lz - 1;
  v.gy = ((t / s.nx) % s.ny) * TY + v.ly - 1;
  v.gx = (t % s.nx) * TX + v.lx - 1;
  v.in = v.gz < s.Z && v.gy < s.Y && v.gx < s.X;
  v.g = ((long long)v.gz * s.Y + v.gy) * s.X + v.gx;
  return v;
}

// The start state, written into both buffers (buffer b, word w of voxel g
// at state[(b * kWords + w) * N + g]), the code (0 outside the mask, 1
// free, 2 seed), and list 1: one CTA per tile.
template <class Rule>
__global__ void __launch_bounds__(kThreads)
init_kernel(int* state, uint8_t* code, typename Rule::Params p,
            const int* __restrict__ seeds, const uint8_t* __restrict__ mask,
            Schedule s) {
  const int t = blockIdx.x;
  const Voxel v = voxel_of(s, t);
  const long long N = (long long)s.Z * s.Y * s.X;
  bool is_free = false;
  if (v.in) {
    const bool m = mask[v.g] != 0;
    const int lab = m ? seeds[v.g] : 0;
    const bool seeded = lab > 0;
    const uint8_t c = seeded ? 2 : (m ? 1 : 0);
    code[v.g] = c;
    is_free = c == 1;
    int w[Rule::kWords];
    Rule::start(w, lab, seeded, p, v.g);
    // the halo words of every voxel; the claimant key, which a step reads
    // only for free voxels, there alone
#pragma unroll
    for (int i = 0; i < Rule::kWords; ++i) {
      if (i < Rule::kHaloWords || is_free) {
        state[i * N + v.g] = w[i];
        state[(Rule::kWords + i) * N + v.g] = w[i];
      }
    }
  }
  const int any = __syncthreads_or(is_free);
  if (threadIdx.x == 0) {
    s.has_free[t] = any ? 1 : 0;
    s.stamp[t] = any ? 1 : 0;
    if (any) s.lists[1 * s.n_tiles + atomicAdd(&s.counts[1], 1)] = t;
  }
}

// Which tiles a voxel that claimed puts on the next list: bit 0 its own
// tile, bit 1 + f the face neighbour across face f (z-, z+, y-, y+, x-, x+)
// when the voxel lies in that face's boundary layer.
__device__ __forceinline__ unsigned next_bits(const Voxel& v) {
  return 1u | (v.lz == 1) << 1 | (v.lz == TZ) << 2 | (v.ly == 1) << 3 |
         (v.ly == TY) << 4 | (v.lx == 1) << 5 | (v.lx == TX) << 6;
}

// One step of tile t: load the halo'd tile from src, relax the interior up
// to inner_cap times, write the free voxels to dst. Returns the OR of
// next_bits over the voxels that claimed (the same in every thread; 0 when
// none did). `flags` is a shared word of this tile's own.
template <class Rule>
__device__ __forceinline__ unsigned relax_tile(
    Tile* sh, unsigned* flags, const int* src, int* dst,
    const uint8_t* __restrict__ code, const typename Rule::Params& p,
    const Schedule& s, int t, long long N, int inner_cap) {
  const int tid = threadIdx.x;
  if (tid == 0) *flags = 0;
  const int z0 = (t / (s.ny * s.nx)) * TZ, y0 = ((t / s.nx) % s.ny) * TY,
            x0 = (t % s.nx) * TX;
  // the code is loaded with the halo, so that the free voxels' own loads
  // wait for one memory round trip, not two
  const Voxel v = voxel_of(s, t);
  const bool is_free = v.in && code[v.g] == 1;
  for (int i = tid; i < kHalo; i += kThreads) {
    const int lx = i % HX, ly = (i / HX) % HY, lz = i / (HX * HY);
    const int gx = x0 + lx - 1, gy = y0 + ly - 1, gz = z0 + lz - 1;
    const bool in = gx >= 0 && gx < s.X && gy >= 0 && gy < s.Y && gz >= 0 &&
                    gz < s.Z;
    const long long g = (gz * (long long)s.Y + gy) * s.X + gx;
    for (int w = 0; w < Rule::kHaloWords; ++w)
      sh[w][lz][ly][lx] = in ? __ldcg(src + w * N + g) : halo_fill(w);
  }
  typename Rule::Own own;
  if (is_free) Rule::load(own, src, N, v, p, s);
  __syncthreads();

  bool claimed_any = false, mine = false;
  for (int it = 0; it < inner_cap; ++it) {
    typename Rule::Best b;
    const bool claim = is_free && Rule::best(b, sh, own, v, s);
    // every thread has read its neighbours before any writes its own voxel
    const int any = __syncthreads_or(claim);
    if (claim) {
      Rule::apply(sh, own, b, v);
      mine = true;
    }
    if (!any) break;
    claimed_any = true;
    __syncthreads();
  }
  if (is_free) Rule::store(dst, N, v, sh, own);
  if (!claimed_any) return 0u;
  const unsigned bits =
      __reduce_or_sync(0xffffffffu, mine ? next_bits(v) : 0u);
  if ((tid & 31) == 0 && bits) atomicOr(flags, bits);
  __syncthreads();
  return *(volatile unsigned*)flags;
}

// Put tile t (which = 0) or its face neighbour across face which - 1 (z-,
// z+, y-, y+, x-, x+) on list `step` unless it is off the grid, holds no
// free voxel or is on it already.
__device__ __forceinline__ void enqueue(const Schedule& s, int t, int which,
                                        int step) {
  int z = t / (s.ny * s.nx), y = (t / s.nx) % s.ny, x = t % s.nx;
  switch (which) {
    case 1: --z; break;
    case 2: ++z; break;
    case 3: --y; break;
    case 4: ++y; break;
    case 5: --x; break;
    case 6: ++x; break;
    default: break;
  }
  if (z < 0 || z >= s.nz || y < 0 || y >= s.ny || x < 0 || x >= s.nx) return;
  const int u = (z * s.ny + y) * s.nx + x;
  if (!__ldg(s.has_free + u)) return;
  if (atomicMax(&s.stamp[u], step) < step)
    s.lists[(step % 3) * s.n_tiles + atomicAdd(&s.counts[step % 3], 1)] = u;
}

// The whole flood after the init kernel: steps 1..max_steps over the
// worklists, a grid sync between steps. result = (steps, converged,
// tile_steps).
template <class Rule>
__global__ void __launch_bounds__(kThreads, kStepBlocksPerSM)
run_kernel(int* state, const uint8_t* __restrict__ code,
           typename Rule::Params p, Schedule s, int inner_cap, int max_steps,
           long long* result) {
  // two shared tiles, used in turn: a CTA loads its next tile while the
  // threads that put the last one's neighbours on the next list finish
  __shared__ Tile sh[2][Rule::kHaloWords];
  __shared__ unsigned flags[2];
  cg::grid_group grid = cg::this_grid();
  const long long N = (long long)s.Z * s.Y * s.X;
  const int tid = threadIdx.x;
  long long tile_steps = 0;
  int steps = max_steps, converged = 0, turn = 0;
  for (int k = 1; k <= max_steps; ++k) {
    const int* src = state + ((k & 1) ? 0 : Rule::kWords * N);
    int* dst = state + ((k & 1) ? Rule::kWords * N : 0);
    const int n = __ldcg(s.counts + k % 3);
    if (blockIdx.x == 0 && tid == 0) {
      atomicExch(&s.counts[(k + 2) % 3], 0);
      tile_steps += n;
    }
    const int* list = s.lists + (k % 3) * s.n_tiles;
    int next_t = blockIdx.x < n ? __ldcg(list + blockIdx.x) : 0;
    for (int i = blockIdx.x; i < n; i += gridDim.x, turn ^= 1) {
      // sh[turn] and flags[turn] were last used two tiles ago: every
      // thread was done with them before the barrier after the previous
      // tile's halo load
      const int t = next_t;  // loaded one tile ahead
      if (i + gridDim.x < n) next_t = __ldcg(list + i + gridDim.x);
      const unsigned bits = relax_tile<Rule>(sh[turn], &flags[turn], src,
                                             dst, code, p, s, t, N, inner_cap);
      if (tid < 7 && (bits >> tid & 1u)) enqueue(s, t, tid, k + 1);
    }
    grid.sync();
    if (__ldcg(s.counts + (k + 1) % 3) == 0) {
      steps = k;
      converged = 1;
      break;
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    result[0] = steps;
    result[1] = converged;
    result[2] = tile_steps;
  }
}

// Host side: zero the list counts, then one init launch (one CTA per
// tile). Returns the first CUDA error, 0 on success.
template <class Rule>
int launch_init(int* state, uint8_t* code, typename Rule::Params p,
                const int* seeds, const uint8_t* mask, int Z, int Y, int X,
                int* work, cudaStream_t stream) {
  const Schedule s = make_schedule(Z, Y, X, work);
  cudaError_t err = cudaMemsetAsync(s.counts, 0, 3 * sizeof(int), stream);
  if (err != cudaSuccess || s.n_tiles == 0) return (int)err;
  init_kernel<Rule><<<s.n_tiles, kThreads, 0, stream>>>(state, code, p, seeds,
                                                        mask, s);
  return (int)cudaGetLastError();
}

// Host side: the one cooperative launch of the step kernel, sized to the
// CTAs that can be resident at once. A refused launch (for instance
// cudaErrorCooperativeLaunchTooLarge) is returned, never retried another
// way.
template <class Rule>
int launch_run(int* state, const uint8_t* code, typename Rule::Params p,
               int Z, int Y, int X, int inner_cap, int max_steps, int* work,
               long long* result, cudaStream_t stream) {
  Schedule s = make_schedule(Z, Y, X, work);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, run_kernel<Rule>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int blocks = sms * per_sm;
  if (s.n_tiles < blocks) blocks = s.n_tiles > 0 ? s.n_tiles : 1;
  void* args[] = {&state, &code, &p, &s, &inner_cap, &max_steps, &result};
  err = cudaLaunchCooperativeKernel((const void*)run_kernel<Rule>,
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace flood
