// Viterbi decode in two kernels: the max-plus forward pass that writes a
// backpointer map per step, and the backtrack that walks the maps.
//
// Replaces:
// - hhmm_tpu/kernels/pallas_semiring.py::_semiring_fwd_kernel in mode
//   "viterbi" (line 361), launched by its pallas_call at line 732 in
//   semiring_viterbi (hhmm_viterbi_fwd below);
// - hhmm_tpu/kernels/pallas_semiring.py::_backtrack_kernel (line 552),
//   launched by its pallas_call at line 745 (hhmm_viterbi_backtrack).
// kernels/dispatch.py::viterbi_dispatch reaches both for a homogeneous
// f32 log_A. The TPU kernels walk (128-lane batch tile, time block) grids
// and carry delta (forward) and the current state (backtrack) across
// time blocks in VMEM scratch. Here the forward pass is fwd_core.cuh's
// forward_kernel in its max-plus mode at K <= 32 (a group of threads a
// lane, delta and a column of A a thread in registers, obs and mask in a
// shared-memory ring; that header has the design), wide_core.cuh's
// wide_forward_kernel up to 128 (a block a lane) and big_core.cuh's
// big_forward_kernel above, and the backtrack a thread a lane chasing
// through maps streamed into shared memory (below), or above K = 256
// read straight from device memory.
//
// Math, per lane (f32; max-plus has no summation order, so the outputs
// are identical to the plain version's, not merely close):
//   delta_0    = pi + obs_0            (no mask case at t = 0, as in the
//                                       reference Viterbi)
//   s[i][j]    = delta_{t-1}[i] + A[i][j]
//   delta_t[j] = max_i s[i][j] + obs_t[j]
//   back_t[j]  = first argmax_i s[i][j]: the lowest index wins a tie and
//                an all -inf column gives 0
//   a masked step (mask_t <= 0) copies delta and writes the identity map;
//   back_0 is the identity map (never read);
//   score = max_j delta_{T-1}; the backtrack starts from
//   z_{T-1} = first argmax_j delta_{T-1} and steps z_{t-1} = back_t[z_t].
//   A padded tail is a run of identity maps, so the path repeats the
//   last valid state there.
//
// Backpointer maps are packed B bits a destination, B = 4 up to K = 16,
// 8 up to 256 and 16 above, into W = ceil(K / P) 32-bit words per (step,
// lane), P = 32 / B states a word: field j % P of word j / P holds
// back_t[j].
// Layout: batch-minor, lane n fastest — pi/dlast [K,N], A [K,K,N], obs
// [T,K,N], mask/path [T,N], back [T,W,N], score [N] — coalesced across a
// warp; a map costs 4 W bytes.
//
// The backtrack, BWD_SAMPLE's phases B and C applied to these maps. What
// bounds it: per lane, T dependent steps z_{t-1} = (back_t[z_t / P] >> B
// (z_t % P)) & (2^B - 1); across lanes, the bytes (the maps in, the path
// out). A block owns L lanes (32, fewer while that leaves an SM without
// a block or the ring past 100 KB) and 128 threads:
// - warps 1..3 copy the maps into a shared-memory ring of kBtStages
//   stages of kBtChunk steps (64 for nibble maps, 32 for byte maps),
//   filled backward in time with cp.async, kBtStages - 1 chunks ahead of
//   the chase. Up to K = 16 with 16 lanes or more, a stage keeps the
//   chunk's rows as they lie in device memory (row (s - s_lo) W + q: word
//   q of step s, L lanes side by side); otherwise a row a lane (word q of
//   step s at (s - s_lo) W + q of the lane's row): kBtLaneFastestLanes;
// - thread l of warp 0 chases lane l: up to K = 16 it reads its words of
//   the chunk into registers and walks them with a shift and a mask a
//   step (and at W = 2 a select of the word), as BWD_SAMPLE's phase B; above
//   16 it reads the pointer's byte itself, z = map_bytes[(s - s_lo) 4 W +
//   z], one shared load a step, the same chain for every W up to 32;
// - each chunk's z go to shared memory, and warps 1..3 write them out
//   while warp 0 chases the next chunk, coalesced over the block's lanes.
// One __syncthreads() a chunk: after it the chunk has landed, the last
// chunk's z are written, and its ring stage is free again.
//
// The chase stays apart from BWD_SAMPLE's phase B (ffbs_bwd_sample.cu):
// there a lane's maps are whole in shared memory, written by phase A in
// place, and its K <= 16 instructions stay as they are.

#include "big_core.cuh"
#include "fwd_core.cuh"
#include "wide_core.cuh"

namespace {

using hhmm::for_k;

constexpr int kBtThreads = 128;  // warp 0 chases, warps 1..3 copy
constexpr int kBtPad = 4;        // words after each lane's row: 16-byte rows, spread banks
constexpr size_t kBtMaxSmem = 100 * 1024;  // fewer lanes a block past this (wide byte maps)

// steps a ring stage and ring stages: a nibble map is 1 or 2 words a step
// (its chunk read into registers), a byte map up to 32
template <int MODE>
constexpr int kBtChunk = MODE ? 64 : 32;
template <int MODE>
constexpr int kBtStages = MODE ? 4 : 3;
constexpr int kBtMaxLanes = 32;  // lanes a block, at most: a warp of chasers
// Nibble maps from this many lanes a block on: a stage holds the chunk's
// rows of L words as they lie in device memory (lane fastest), copied 16
// bytes at a time where N % 4 == 0, each chaser reading its lane's column
// with 4-byte loads; no bank conflict on either side. Below it, and for
// byte maps, a row of the chunk's words a lane (lane major), which the
// chaser reads with 16-byte loads, or addresses by byte; its rows lie 4
// mod 32 words apart, so the copies of 16 or more lanes meet 4-way bank
// conflicts. On an H100 at T=1024: lane fastest 0.0280 / 0.0405 ms at
// N=8192, K=4 / 16 (lane major 0.0379 / 0.0615); lane major 0.0138 /
// 0.0145 ms on one lane (lane fastest 0.0157 / 0.0206).
constexpr int kBtLaneFastestLanes = 16;

template <int MODE>
__host__ __device__ constexpr int bt_row(int W) { return kBtChunk<MODE> * W + kBtPad; }

template <int MODE>
constexpr size_t bt_smem_bytes(int W, int lanes) {
  return sizeof(uint32_t) * (static_cast<size_t>(kBtStages<MODE>) * lanes * bt_row<MODE>(W) +
                             2 * kBtChunk<MODE> * lanes);
}

// MODE: the nibble maps' words a step (1: K <= 8, 2: K <= 16), or 0: the
// byte maps (K > 16, W = ceil(K / 4) at runtime). 1 << lg lanes a block.
template <int MODE>
__global__ void __launch_bounds__(kBtThreads)
viterbi_backtrack_kernel(int K, const uint32_t* __restrict__ back,
                         const float* __restrict__ dlast, int* __restrict__ path, int T,
                         int N, int lg) {
  constexpr int kStages = kBtStages<MODE>, kChunk = kBtChunk<MODE>;
  extern __shared__ __align__(16) uint32_t bt_smem[];
  const int L = 1 << lg;
  const int W = MODE ? MODE : (K + 3) / 4;
  const int row = bt_row<MODE>(W);
  int* zs = reinterpret_cast<int*>(bt_smem + kStages * L * row);  // [2][kChunk][L]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * L;
  const size_t sN = static_cast<size_t>(N);
  const bool chaser = tid < 32;
  const int S = T - 1;  // steps of the walk, s = T-1 .. 1
  const int chunks = (S + kChunk - 1) / kChunk;

  // chunk c: steps s_top = T-1 - c kChunk down to s_lo = max(s_top -
  // kChunk + 1, 1); copied by warps 1..3, one commit group a thread
  const bool lane_fastest = MODE != 0 && L >= kBtLaneFastestLanes;
  // 16-byte copies and stores: four lanes' words, aligned when N % 4 == 0
  const bool vec = (N & 3) == 0 && lg >= 2;
  auto issue = [&](int c) {
    if (c < chunks) {
      const int s_top = T - 1 - c * kChunk;
      const int s_lo = s_top - kChunk + 1 > 1 ? s_top - kChunk + 1 : 1;
      const int rows = (s_top - s_lo + 1) * W;
      const uint32_t* src = back + static_cast<size_t>(s_lo) * W * sN + n0;
      uint32_t* dst = bt_smem + (c % kStages) * L * row;
      if (lane_fastest && vec) {
        for (int e = tid - 32; e < rows << (lg - 2); e += kBtThreads - 32) {
          const int r = e >> (lg - 2), l = 4 * (e & ((L >> 2) - 1));
          if (n0 + l < N) hhmm::cp_async16(dst + r * L + l, src + r * sN + l);
        }
      } else {
        for (int e = tid - 32; e < rows << lg; e += kBtThreads - 32) {
          const int r = e >> lg, l = e & (L - 1);
          if (n0 + l < N)
            hhmm::cp_async4(dst + (lane_fastest ? r * L + l : l * row + r), src + r * sN + l);
        }
      }
    }
    hhmm::cp_async_commit();
  };
  // the z of chunk c, from zs[c & 1], to path rows s - 1
  auto write_out = [&](int c) {
    const int s_top = T - 1 - c * kChunk;
    const int s_lo = s_top - kChunk + 1 > 1 ? s_top - kChunk + 1 : 1;
    const int* src = zs + (c & 1) * kChunk * L;
    int* dst = path + static_cast<size_t>(s_lo - 1) * sN + n0;
    if (vec) {
      for (int e = tid - 32; e < (s_top - s_lo + 1) << (lg - 2); e += kBtThreads - 32) {
        const int k = e >> (lg - 2), l = 4 * (e & ((L >> 2) - 1));
        if (n0 + l < N)
          *reinterpret_cast<int4*>(dst + k * sN + l) =
              *reinterpret_cast<const int4*>(src + k * L + l);
      }
    } else {
      for (int e = tid - 32; e < (s_top - s_lo + 1) << lg; e += kBtThreads - 32) {
        const int k = e >> lg, l = e & (L - 1);
        if (n0 + l < N) dst[k * sN + l] = src[e];
      }
    }
  };

  const int n = n0 + tid;
  const bool chases = chaser && tid < L && n < N;
  uint32_t z = 0;
  if (chases) {
    float best = dlast[n];
    for (int k = 1; k < K; ++k) {
      const float d = dlast[k * sN + n];
      if (d > best) {
        best = d;
        z = static_cast<uint32_t>(k);
      }
    }
    path[static_cast<size_t>(T - 1) * sN + n] = static_cast<int>(z);
  }
  if (!chaser) {
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) issue(q);
  }
  for (int c = 0; c < chunks; ++c) {
    if (!chaser) hhmm::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (!chaser) {
      issue(c + kStages - 1);
      if (c > 0) write_out(c - 1);
    } else if (chases) {
      const int s_top = T - 1 - c * kChunk;
      const int s_lo = s_top - kChunk + 1 > 1 ? s_top - kChunk + 1 : 1;
      const int valid = s_top - s_lo + 1;  // slots 0 .. valid-1, slot k = step s_lo + k
      const uint32_t* stage = bt_smem + (c % kStages) * L * row;
      const uint32_t* words = stage + tid * row;  // byte maps: this lane's row
      int* zc = zs + (c & 1) * kChunk * L + tid;
      if constexpr (MODE == 0) {
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(words);
        for (int k = valid - 1; k >= 0; --k) {
          z = bytes[k * 4 * W + z];
          zc[k * L] = static_cast<int>(z);
        }
      } else {
        uint32_t w[MODE * kChunk];
        if (lane_fastest) {  // this lane's column of the chunk's rows
#pragma unroll
          for (int r = 0; r < MODE * kChunk; ++r) w[r] = stage[r * L + tid];
        } else {
          const uint4* v = reinterpret_cast<const uint4*>(words);
#pragma unroll
          for (int q = 0; q < MODE * kChunk / 4; ++q) {
            const uint4 x = v[q];
            w[4 * q] = x.x;
            w[4 * q + 1] = x.y;
            w[4 * q + 2] = x.z;
            w[4 * q + 3] = x.w;
          }
        }
        // one step: a shift and a mask (and at W = 2 a select)
        auto step = [&](int k) {
          if constexpr (MODE == 1) {
            z = (w[k] >> (4u * z)) & 15u;
          } else {
            z = (((z & 8u) ? w[2 * k + 1] : w[2 * k]) >> (4u * (z & 7u))) & 15u;
          }
          zc[k * L] = static_cast<int>(z);
        };
        if (valid == kChunk) {  // every chunk but the last: no test on the chain
#pragma unroll
          for (int k = kChunk - 1; k >= 0; --k) step(k);
        } else {
#pragma unroll
          for (int k = kChunk - 1; k >= 0; --k)
            if (k < valid) step(k);
        }
      }
    }
  }
  __syncthreads();
  if (!chaser && chunks > 0) write_out(chunks - 1);
}

// Above K = 256 (16-bit fields, W = ceil(K / 2) words a step): a thread
// a lane, z_{T-1} the first argmax of dlast, then z_{t-1} = field z % 2
// of word z / 2 of step t read straight from device memory, one
// dependent load a step. A simple design: the maps of a chunk of steps
// (W words a step and lane, 2 KB at K = 1024) would crowd the ring of
// the byte kernel above.
__global__ void __launch_bounds__(kBtThreads)
viterbi_backtrack_big_kernel(int K, const uint32_t* __restrict__ back,
                             const float* __restrict__ dlast, int* __restrict__ path, int T,
                             int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t sN = static_cast<size_t>(N);
  const size_t W = static_cast<size_t>((K + 1) / 2);
  float best = dlast[n];
  uint32_t z = 0;
  for (int k = 1; k < K; ++k) {
    const float d = dlast[k * sN + n];
    if (d > best) {
      best = d;
      z = static_cast<uint32_t>(k);
    }
  }
  path[static_cast<size_t>(T - 1) * sN + n] = static_cast<int>(z);
  for (int t = T - 1; t > 0; --t) {
    const uint32_t word = back[(t * W + (z >> 1)) * sN + n];
    z = (word >> (16u * (z & 1u))) & 0xffffu;
    path[static_cast<size_t>(t - 1) * sN + n] = static_cast<int>(z);
  }
}

// the card's SMs, read once
int sm_count() {
  static const int count = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      v = 132;
    return v;
  }();
  return count;
}

template <int MODE>
int launch_backtrack(int K, const uint32_t* back, const float* dlast, int* path, int T,
                     int N, cudaStream_t stream) {
  // kBtMaxLanes a block, fewer while that leaves an SM without a block or
  // the ring past kBtMaxSmem
  const int W = MODE ? MODE : (K + 3) / 4;
  int lg = 0;
  while ((2 << lg) <= kBtMaxLanes) ++lg;
  while (lg > 0 && (((N + (1 << lg) - 1) >> lg) < sm_count() ||
                    bt_smem_bytes<MODE>(W, 1 << lg) > kBtMaxSmem))
    --lg;
  const size_t smem = bt_smem_bytes<MODE>(W, 1 << lg);
  const int rc = hhmm::wide_launch_setup<viterbi_backtrack_kernel<MODE>>(smem);
  if (rc != 0) return rc;
  const int grid = (N + (1 << lg) - 1) >> lg;
  viterbi_backtrack_kernel<MODE><<<grid, kBtThreads, smem, stream>>>(K, back, dlast, path, T,
                                                                     N, lg);
  return 0;
}

int launch_backtrack_big(int K, const uint32_t* back, const float* dlast, int* path, int T,
                         int N, cudaStream_t stream) {
  const int grid = (N + kBtThreads - 1) / kBtThreads;
  viterbi_backtrack_big_kernel<<<grid, kBtThreads, 0, stream>>>(K, back, dlast, path, T, N);
  return 0;
}

}  // namespace

// Both entry points return 0 on a good launch, the cudaError_t of a
// refused one, or -1 for a K below 1 or an empty shape. They launch on
// `stream` and do not synchronise; the caller owns every buffer (`back`
// is int32 [T, W, N], one packed map of W words per step; above K = 128
// the forward pass takes and frees a stream-ordered scratch for the
// lanes' A).
extern "C" int hhmm_viterbi_fwd(int K, const float* pi, const float* A,
                                const float* obs, const float* mask,
                                float* score, float* dlast, int* back, int T,
                                int N, void* stream) {
  if (T < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* b = reinterpret_cast<uint32_t*>(back);
  const int rc =
      K > hhmm::kMaxK
          ? hhmm::launch_big_forward<hhmm::kMaxPlus, false>(K, pi, A, obs, mask, nullptr,
                                                            nullptr, score, nullptr, dlast, b,
                                                            T, N, s)
      : K > hhmm::kMaxGroupK
          ? hhmm::launch_wide_forward<hhmm::kMaxPlus, false>(K, pi, A, obs, mask, nullptr,
                                                             nullptr, score, nullptr, dlast, b,
                                                             T, N, s)
          : for_k<hhmm::kMaxGroupK>(K, [&](auto k) {
              return hhmm::launch_forward<decltype(k)::value, hhmm::kMaxPlus, false>(
                  pi, A, obs, mask, nullptr, nullptr, score, nullptr, dlast, b, T, N, s);
            });
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

extern "C" int hhmm_viterbi_backtrack(int K, const int* back,
                                      const float* dlast, int* path, int T,
                                      int N, void* stream) {
  if (T < 1 || N < 1 || K < hhmm::kMinK) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(back);
  const int rc = K <= 8                  ? launch_backtrack<1>(K, b, dlast, path, T, N, s)
                 : K <= hhmm::kMaxNibbleK ? launch_backtrack<2>(K, b, dlast, path, T, N, s)
                 : K <= hhmm::kMaxByteK   ? launch_backtrack<0>(K, b, dlast, path, T, N, s)
                                          : launch_backtrack_big(K, b, dlast, path, T, N, s);
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
