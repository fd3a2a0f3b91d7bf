// Greedy single-class non-max suppression: order, suppression mask, scan.
//
// Replaces the TPU kernel mtlx/kernels/nms_pallas.py
// non_max_suppression_pallas (kernel body _nms_kernel).
//
// What bounds it on Hopper: neither bytes (6000 boxes are 144 KB) nor
// arithmetic, but dependence. Greedy NMS picks in priority order and each
// pick decides the later ones, so a kernel that repeats the TPU kernel's
// loop (an argmax and a suppress pass per output slot) is a chain of
// max_out block-wide reductions on one SM while 131 SMs idle.
//
// What the design does about it: only the decisions are a chain, the
// arithmetic is not, so the arithmetic leaves the chain and spreads over
// the card.
//   1. Order. Every row gets its priority rank by counting the rows with
//      a greater packed 64-bit key (order-preserving score bits, then the
//      complement of the index: keys are unique, ties go to the lower
//      index, dead rows carry the score -1e10 and come last). The N^2
//      compares are spread over the grid; the boxes are then written in
//      rank order with their original indices.
//   2. Mask. For ordered boxes, word w of row i has bit b set when
//      iou(box_i, box_{64w+b}) > iou_threshold and 64w+b > i. Blocks of 64
//      rows x 256 columns (x 64 where that fills the card better) cover
//      the upper triangle, all over the grid.
//   3. Scan. One block per problem walks the ordered rows 64 at a time
//      with a `removed` bit vector in shared memory: one thread resolves
//      the chunk's 64 x 64 diagonal words serially (no barrier inside),
//      then all threads OR the kept rows' mask words into `removed`. It
//      stops at max_out picks or at the first dead row and pads the rest
//      with index 0 / keep False.
//   Bands: 300 picks out of 6000 usually come from the first part of the
//   order, so mask and scan alternate over bands of row chunks (16, 32,
//   64, ... chunks); once a problem is done its later blocks return at
//   once, and the mask rows the scan would never read are not computed.
//   Small N (up to kSmallMaxBoxes): one block per problem ranks, masks
//   and scans in shared memory in a single launch. The device time is the
//   pipeline's; the caller saves the host's time for three launches,
//   which is what the served postprocess (300 rows a problem) waits for.
//   At 1024 rows the one block is slower than the pipeline over the grid.
//
// Exactness: the IoU is evaluated in the reference's operation order and
// this file is compiled with --fmad=false. The test `inter / union >
// threshold` is first decided without the division where a guard band of
// 2^-20 around `threshold * union` makes the rounded quotient's side
// certain, and by the IEEE division itself inside the band, so every bit
// of the mask equals the plain PyTorch version's decision.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr float kNeg = -1e10f;  // mtlx.ops.nms._NEG
constexpr int kSmallMaxBoxes = 512;    // the single-launch form: N up to here
constexpr int kMaxBoxes = 8192;        // the scan holds `removed` in 128 words
constexpr int kRankThreads = 128;      // threads of a block of the rank count
constexpr int kRankRows = 4;           // rows of i per thread: one key load, 4 compares
constexpr int kRankTile = 1024;        // keys of j in shared memory at a time
constexpr int kRankMaxSplits = 32;     // blocks that share one row's count
constexpr int kScanThreads = 1024;     // 128 words x 8 groups of kept rows
constexpr int kFirstBandChunks = 16;   // the first band; each next one doubles

__device__ __forceinline__ unsigned int sortable_bits(float s) {
  if (s == 0.0f) s = 0.0f;  // -0 and +0 compare equal in the reference
  unsigned int u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 pack_key(float s, int i) {
  return (static_cast<u64>(sortable_bits(s)) << 32) |
         static_cast<u64>(0xffffffffu - static_cast<unsigned int>(i));
}

// A row can be picked when it is valid and its score passes the threshold;
// a score at or below -1e10 / 2 ends the reference's loop, so it is dead.
__device__ __forceinline__ bool is_live(float s, unsigned char valid, float score_threshold) {
  return valid && s > score_threshold && s > kNeg / 2;
}

__device__ __forceinline__ u64 row_key(const float* scores, const unsigned char* valid,
                                       int i, float score_threshold) {
  const float s = scores[i];
  return pack_key(is_live(s, valid[i], score_threshold) ? s : kNeg, i);
}

// The IoU test's constants: the threshold and its guard band (-inf and
// +inf, i.e. no band, for a threshold outside [2^-10, 1], where the
// band's products could leave the normal range).
struct Thresh {
  float thr, lo, hi;
};

// The division itself, out of line: it is needed only inside the guard
// band, so the mask loops stay short.
__device__ __noinline__ bool quotient_over(float inter, float u, float thr) {
  return inter / u > thr;
}

// iou(a, b) > thr with the reference's rounding: area_a + area_b - inter
// and inter / max(union, 1e-30), each operation rounded once.
__device__ __forceinline__ bool overlaps(const float4 a, float area_a, const float4 b,
                                         float area_b, const Thresh t) {
  const float ih = fmaxf(0.0f, fminf(a.z, b.z) - fmaxf(a.x, b.x));
  const float iw = fmaxf(0.0f, fminf(a.w, b.w) - fmaxf(a.y, b.y));
  const float inter = ih * iw;
  const float uni = area_a + area_b - inter;
  if (!(uni > 0.0f)) return 0.0f > t.thr;
  const float u = fmaxf(uni, 1e-30f);
  // fl(inter / u) > thr is certain outside thr * u * (1 -+ 2^-20)
  if (inter > t.hi * u) return true;
  if (inter < t.lo * u) return false;
  return quotient_over(inter, u, t.thr);
}

__device__ __forceinline__ float box_area(const float4 b) {
  return (b.z - b.x) * (b.w - b.y);
}

// One word of the mask: bit b is set when `a` overlaps column box b of the
// `cols` (at most 64) boxes at `boxes`, the same for every thread of a warp.
__device__ __forceinline__ u64 mask_word(const float4 a, float area_a, const float4* boxes,
                                         const float* areas, int cols, const Thresh t) {
  unsigned int half[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int m = min(32, cols - 32 * k);
#pragma unroll 8
    for (int b = 0; b < m; ++b)
      half[k] |= (overlaps(a, area_a, boxes[32 * k + b], areas[32 * k + b], t) ? 1u : 0u) << b;
  }
  return (static_cast<u64>(half[1]) << 32) | half[0];
}

// Clears the bits of a row's own word up to and including the row itself.
__device__ __forceinline__ u64 after_row(u64 bits, int row) {
  return bits & ~((2ull << (row & 63)) - 1ull);
}

// ------------------------------------------------------ banded pipeline

struct ScanState {
  int count;  // picks written so far
  int done;   // the problem is finished and its output padded
  u64 removed[kMaxBoxes / 64];
};

// partial[p][s][i] = #{j in split s : key_j > key_i}. A thread keeps
// kRankRows keys of i in registers, so one shared-memory load of two keys
// of j feeds 2 * kRankRows compares.
__global__ void rank_kernel(const float* __restrict__ scores,
                            const unsigned char* __restrict__ valid, int n,
                            float score_threshold, int splits,
                            int* __restrict__ partial) {
  __shared__ __align__(16) u64 keys[kRankTile];
  const int p = blockIdx.z;
  const int s = blockIdx.y;
  const int row0 = blockIdx.x * kRankThreads * kRankRows + threadIdx.x;
  const float* ps = scores + static_cast<size_t>(p) * n;
  const unsigned char* pv = valid + static_cast<size_t>(p) * n;
  const int per = (n + splits - 1) / splits;
  const int j0 = s * per;
  const int j1 = min(n, j0 + per);
  u64 ki[kRankRows];
  int cnt[kRankRows];
#pragma unroll
  for (int r = 0; r < kRankRows; ++r) {
    const int i = row0 + r * kRankThreads;
    ki[r] = i < n ? row_key(ps, pv, i, score_threshold) : ~0ull;
    cnt[r] = 0;
  }
  for (int base = j0; base < j1; base += kRankTile) {
    const int m = min(kRankTile, j1 - base);
    for (int t = threadIdx.x; t < kRankTile; t += kRankThreads)
      keys[t] = t < m ? row_key(ps, pv, base + t, score_threshold) : 0ull;
    __syncthreads();
    const int pairs = (m + 1) >> 1;  // the tile's tail holds key 0, greater than none
#pragma unroll 4
    for (int t = 0; t < pairs; ++t) {
      const ulonglong2 kj = reinterpret_cast<const ulonglong2*>(keys)[t];
#pragma unroll
      for (int r = 0; r < kRankRows; ++r)
        cnt[r] += (kj.x > ki[r] ? 1 : 0) + (kj.y > ki[r] ? 1 : 0);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRankRows; ++r) {
    const int i = row0 + r * kRankThreads;
    if (i < n) partial[(static_cast<size_t>(p) * splits + s) * n + i] = cnt[r];
  }
}

// Writes the boxes and original indices (-1 for a dead row) in rank order
// and resets the problem's scan state.
__global__ void order_kernel(const float* __restrict__ boxes,
                             const float* __restrict__ scores,
                             const unsigned char* __restrict__ valid, int n,
                             float score_threshold, int splits,
                             const int* __restrict__ partial,
                             float4* __restrict__ sboxes, int* __restrict__ sidx,
                             ScanState* __restrict__ state) {
  const int p = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0) {
    ScanState* st = state + p;
    if (threadIdx.x == 0) {
      st->count = 0;
      st->done = 0;
    }
    for (int w = threadIdx.x; w < kMaxBoxes / 64; w += blockDim.x) st->removed[w] = 0ull;
  }
  if (i >= n) return;
  const size_t row = static_cast<size_t>(p) * n + i;
  int rank = 0;
  for (int s = 0; s < splits; ++s)
    rank += partial[(static_cast<size_t>(p) * splits + s) * n + i];
  const size_t dst = static_cast<size_t>(p) * n + rank;
  sboxes[dst] = reinterpret_cast<const float4*>(boxes)[row];
  sidx[dst] = is_live(scores[row], valid[row], score_threshold) ? i : -1;
}

// One block: 64 ordered rows (chunk r) against kMaskColWords column words
// (4, so a thread writes 32 contiguous bytes; 1 where the grid would
// otherwise leave SMs idle).
template <int kMaskColWords>
__global__ void mask_kernel(const float4* __restrict__ sboxes,
                            const int* __restrict__ sidx, int n, int words,
                            int chunk0, Thresh t,
                            const ScanState* __restrict__ state,
                            u64* __restrict__ mask) {
  __shared__ float4 cbox[64 * kMaskColWords];
  __shared__ float carea[64 * kMaskColWords];
  const int p = blockIdx.z;
  const int r = chunk0 + blockIdx.y;
  const int w0 = blockIdx.x * kMaskColWords;
  if (w0 + kMaskColWords <= r) return;  // below the diagonal
  if (state[p].done) return;
  const float4* pb = sboxes + static_cast<size_t>(p) * n;
  const int* pi = sidx + static_cast<size_t>(p) * n;
  if (pi[64 * r] < 0) return;  // the scan stops before a dead row
  const int tid = threadIdx.x;
  for (int k = tid; k < 64 * kMaskColWords; k += 64) {
    const int j = 64 * w0 + k;
    const float4 b = j < n ? pb[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    cbox[k] = b;
    carea[k] = box_area(b);
  }
  __syncthreads();
  const int i = 64 * r + tid;
  if (i >= n) return;
  const float4 a = pb[i];
  const float area_a = box_area(a);
  const size_t rows = static_cast<size_t>(words) * 64;
  u64* out = mask + (static_cast<size_t>(p) * rows + i) * words;
  for (int q = 0; q < kMaskColWords; ++q) {
    const int w = w0 + q;
    if (w < r || w >= words) continue;
    // columns of a chunk that starts dead are never reached by the scan
    if (pi[64 * w] < 0) continue;
    const u64 bits =
        mask_word(a, area_a, cbox + 64 * q, carea + 64 * q, min(64, n - 64 * w), t);
    out[w] = w == r ? after_row(bits, i) : bits;  // only columns after the row
  }
}

// One block per problem: the ordered walk over chunks [chunk0, chunk1).
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ sidx, const u64* __restrict__ mask, int n, int words,
            int chunk0, int chunk1, int last, int max_out, ScanState* __restrict__ state,
            int* __restrict__ idx_out, unsigned char* __restrict__ keep_out) {
  __shared__ u64 removed[kMaxBoxes / 64];
  __shared__ u64 diag[64];
  __shared__ int orig[64];
  __shared__ unsigned int live_bits[2];
  __shared__ u64 s_kept;
  __shared__ int s_count, s_done;
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  ScanState* st = state + p;
  if (st->done) return;
  const int* pi = sidx + static_cast<size_t>(p) * n;
  const size_t rows = static_cast<size_t>(words) * 64;
  const u64* pm = mask + static_cast<size_t>(p) * rows * words;
  int* pidx = idx_out + static_cast<size_t>(p) * max_out;
  unsigned char* pkeep = keep_out + static_cast<size_t>(p) * max_out;
  if (tid < kMaxBoxes / 64) removed[tid] = st->removed[tid];
  if (tid == 0) {
    s_count = st->count;
    s_done = 0;
  }
  const int w = tid & 127;
  const int group = tid >> 7;
  constexpr int kGroups = kScanThreads / 128;
  // a chunk's diagonal words and original indices are fetched one chunk
  // ahead, while the chunk before is resolved
  u64 next_diag = 0ull;
  int next_orig = -1;
  if (tid < 64) {
    const int row = 64 * chunk0 + tid;
    next_diag = pm[static_cast<size_t>(row) * words + chunk0];
    next_orig = row < n ? pi[row] : -1;
  }
  for (int c = chunk0; c < chunk1; ++c) {
    if (tid < 64) {  // warps 0 and 1, whole
      diag[tid] = next_diag;
      orig[tid] = next_orig;
      const unsigned int live = __ballot_sync(0xffffffffu, next_orig >= 0);
      if ((tid & 31) == 0) live_bits[tid >> 5] = live;
    }
    __syncthreads();
    if (tid < 64 && c + 1 < chunk1) {
      const int row = 64 * (c + 1) + tid;
      next_diag = pm[static_cast<size_t>(row) * words + c + 1];
      next_orig = row < n ? pi[row] : -1;
    }
    if (tid == 0) {
      // the chain: nothing but the bit test and the OR depends on the row
      // before; the loads of the diagonal words do not, and no branch leaves
      // the loop, so it unrolls. Live rows come first in the order.
      const int rows_here = __popc(live_bits[0]) + __popc(live_bits[1]);
      u64 rem = removed[c], kept_rows = 0ull;
      int cnt = s_count;
#pragma unroll 16
      for (int b = 0; b < 64; ++b) {
        const u64 d = diag[b];
        if (b < rows_here && !((rem >> b) & 1ull) && cnt < max_out) {
          rem |= d;
          kept_rows |= 1ull << b;
          ++cnt;
        }
      }
      s_kept = kept_rows;
      s_count = cnt;
      // a dead row or the end of the rows: nothing more to pick
      s_done = (rows_here < 64 || cnt == max_out) ? 1 : 0;
    }
    __syncthreads();
    const u64 kept_rows = s_kept;
    if (tid < 64 && ((kept_rows >> tid) & 1ull)) {
      // s_count already counts this chunk's picks
      const int slot = s_count - __popcll(kept_rows) + __popcll(kept_rows & ((1ull << tid) - 1ull));
      pidx[slot] = orig[tid];
      pkeep[slot] = 1;
    }
    if (s_done) break;
    if (w > c && w < words) {
      u64 acc = 0ull;
#pragma unroll
      for (int b = group; b < 64; b += kGroups)
        if ((kept_rows >> b) & 1ull) acc |= pm[static_cast<size_t>(64 * c + b) * words + w];
      if (acc) atomicOr(&removed[w], acc);
    }
    __syncthreads();
  }
  const int count = s_count;
  if (s_done || last) {
    for (int j = count + tid; j < max_out; j += blockDim.x) {
      pidx[j] = 0;
      pkeep[j] = 0;
    }
    if (tid == 0) st->done = 1;
    return;
  }
  if (tid < kMaxBoxes / 64) st->removed[tid] = removed[tid];
  if (tid == 0) st->count = count;
}

// -------------------------------------------------------- single launch

// One block per problem, everything in shared memory: keys, rank, ordered
// boxes, the mask ([n][words]) and the scan (warp 0).
__global__ void __launch_bounds__(512) nms_small_kernel(const float* __restrict__ boxes,        // [P, N, 4]
                                 const float* __restrict__ scores,       // [P, N]
                                 const unsigned char* __restrict__ valid,  // [P, N]
                                 int n, int words, int max_out, Thresh t,
                                 float score_threshold,
                                 int* __restrict__ idx_out,               // [P, max_out]
                                 unsigned char* __restrict__ keep_out) {  // [P, max_out]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* sbox = reinterpret_cast<float4*>(smem_raw);              // [n]
  u64* keys = reinterpret_cast<u64*>(sbox + n);                     // [n]
  u64* mask = keys + n;                                             // [n][words]
  float* sarea = reinterpret_cast<float*>(mask + static_cast<size_t>(n) * words);  // [n]
  int* sorig = reinterpret_cast<int*>(sarea + n);                   // [n]

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const float4* pb = reinterpret_cast<const float4*>(boxes) + static_cast<size_t>(p) * n;
  const float* ps = scores + static_cast<size_t>(p) * n;
  const unsigned char* pv = valid + static_cast<size_t>(p) * n;
  int* pidx = idx_out + static_cast<size_t>(p) * max_out;
  unsigned char* pkeep = keep_out + static_cast<size_t>(p) * max_out;

  int live_mine = 0;
  for (int i = tid; i < n; i += blockDim.x) {
    const float s = ps[i];
    const bool live = is_live(s, pv[i], score_threshold);
    live_mine += live ? 1 : 0;
    keys[i] = pack_key(live ? s : kNeg, i);
  }
  // __syncthreads_count counts threads, so sum the per-thread counts
  __shared__ int s_live;
  if (tid == 0) s_live = 0;
  __syncthreads();
  if (live_mine) atomicAdd(&s_live, live_mine);
  __syncthreads();
  const int n_live = s_live;

  // order: rank by counting, then the live rows in rank order
  for (int i = tid; i < n; i += blockDim.x) {
    const u64 ki = keys[i];
    int rank = 0;
#pragma unroll 8
    for (int j = 0; j < n; ++j) rank += keys[j] > ki ? 1 : 0;
    if (rank < n_live) {
      const float4 b = pb[i];
      sbox[rank] = b;
      sarea[rank] = box_area(b);
      sorig[rank] = i;
    }
  }
  __syncthreads();

  // mask, live rows only: the items (word w, row i < 64 (w + 1)) word by
  // word, so the threads of a warp read the same column boxes
  const int live_words = (n_live + 63) >> 6;
  // the items before the last word's: 64 + 128 + ... + 64 (live_words - 1)
  const int full = live_words > 0 ? 32 * (live_words - 1) * live_words : 0;
  for (int item = tid; item < full + n_live; item += blockDim.x) {
    int w = 0;
    while (w + 1 < live_words && 32 * (w + 1) * (w + 2) <= item) ++w;
    const int i = item - 32 * w * (w + 1);
    const u64 bits = mask_word(sbox[i], sarea[i], sbox + 64 * w, sarea + 64 * w,
                               min(64, n_live - 64 * w), t);
    // only columns after the row
    mask[static_cast<size_t>(i) * words + w] = w == (i >> 6) ? after_row(bits, i) : bits;
  }
  __syncthreads();

  // scan: warp 0, lane w keeps word w of `removed`
  if (tid >= 32) return;
  const int lane = tid;
  static_assert(kSmallMaxBoxes / 64 <= 32, "one word of `removed` per lane");
  u64 rem = 0ull;
  int count = 0;
  bool done = false;
  for (int c = 0; c < live_words && !done; ++c) {
    const int rows_here = min(64, n_live - 64 * c);
    // the chunk's diagonal words, two a lane, fetched before the chain
    const u64 d_lo = lane < rows_here ? mask[static_cast<size_t>(64 * c + lane) * words + c] : 0ull;
    const u64 d_hi =
        lane + 32 < rows_here ? mask[static_cast<size_t>(64 * c + 32 + lane) * words + c] : 0ull;
    u64 cur = __shfl_sync(0xffffffffu, rem, c);
    u64 kept_rows = 0ull;
    // the chain (every lane runs it alike): only the bit test and the OR
    // depend on the row before
#pragma unroll 16
    for (int b = 0; b < 64; ++b) {
      const u64 d = __shfl_sync(0xffffffffu, b < 32 ? d_lo : d_hi, b & 31);
      if (b < rows_here && !((cur >> b) & 1ull) && count < max_out) {
        cur |= d;
        kept_rows |= 1ull << b;
        ++count;
      }
    }
    const int count0 = count - __popcll(kept_rows);
#pragma unroll
    for (int b = lane; b < 64; b += 32) {
      if ((kept_rows >> b) & 1ull) {
        const int slot = count0 + __popcll(kept_rows & ((1ull << b) - 1ull));
        pidx[slot] = sorig[64 * c + b];
        pkeep[slot] = 1;
      }
    }
    done = count == max_out;
    if (!done && lane > c && lane < live_words) {
      u64 acc = 0ull;
      for (u64 bits = kept_rows; bits; bits &= bits - 1ull)
        acc |= mask[static_cast<size_t>(64 * c + __ffsll(bits) - 1) * words + lane];
      rem |= acc;
    }
  }
  for (int j = count + lane; j < max_out; j += 32) {
    pidx[j] = 0;
    pkeep[j] = 0;
  }
}

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// The banded pipeline's scratch, carved from one buffer.
struct Scratch {
  size_t partial, sboxes, sidx, mask, state, total;
  int splits, words;
};

Scratch scratch_layout(int p, int n) {
  Scratch s;
  s.words = (n + 63) / 64;
  // split the j range so the rank count's blocks fill the card
  const int tiles = (n + kRankThreads * kRankRows - 1) / (kRankThreads * kRankRows);
  int splits = (2 * 132 + tiles * p - 1) / (tiles * p);
  s.splits = splits < 1 ? 1 : (splits > kRankMaxSplits ? kRankMaxSplits : splits);
  const size_t np = static_cast<size_t>(p) * n;
  s.partial = 0;
  s.sboxes = align_up(s.partial + np * s.splits * sizeof(int));
  s.sidx = align_up(s.sboxes + np * sizeof(float4));
  s.mask = align_up(s.sidx + np * sizeof(int));
  s.state = align_up(s.mask + static_cast<size_t>(p) * s.words * 64 * s.words * sizeof(u64));
  s.total = align_up(s.state + static_cast<size_t>(p) * sizeof(ScanState));
  return s;
}

size_t small_smem_bytes(int n) {
  const size_t words = (n + 63) / 64;
  return static_cast<size_t>(n) * (sizeof(float4) + sizeof(u64) + words * sizeof(u64) +
                                   sizeof(float) + sizeof(int));
}

Thresh make_thresh(float thr) {
  Thresh t;
  t.thr = thr;
  if (thr >= 1.0f / 1024.0f && thr <= 1.0f) {
    t.lo = static_cast<float>(static_cast<double>(thr) * (1.0 - 1.0 / 1048576.0));
    t.hi = static_cast<float>(static_cast<double>(thr) * (1.0 + 1.0 / 1048576.0));
  } else {
    t.lo = -INFINITY;
    t.hi = INFINITY;
  }
  return t;
}

// form: 0 picks by N (the single launch up to 512 boxes, the banded
// pipeline above), 1 is the single launch, 2 the banded pipeline.
bool is_small(int n, int form) { return form == 1 || (form == 0 && n <= kSmallMaxBoxes); }

}  // namespace

// The bytes of scratch mtlx_nms_f32 needs for P problems of N boxes in
// this form: 0 for the single launch, -1 where the form does not take N.
extern "C" long long mtlx_nms_scratch_bytes(int num_problems, int n, int form) {
  if (n < 1 || num_problems < 1 || n > (is_small(n, form) ? kSmallMaxBoxes : kMaxBoxes))
    return -1;
  if (is_small(n, form)) return 0;
  if (num_problems > 65535) return -1;  // the problems are a grid's z
  return static_cast<long long>(scratch_layout(num_problems, n).total);
}

// scratch: mtlx_nms_scratch_bytes bytes, 256-byte aligned (unused by the
// single launch). Returns the first CUDA error (0 on success).
extern "C" int mtlx_nms_f32(const void* boxes, const void* scores,
                            const void* valid, int num_problems, int n,
                            int max_out, float iou_threshold,
                            float score_threshold, void* scratch, int form,
                            void* idx_out, void* keep_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  int* idx = static_cast<int*>(idx_out);
  unsigned char* keep = static_cast<unsigned char*>(keep_out);
  if (n > kMaxBoxes || n < 1 || num_problems < 1 || max_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Thresh t = make_thresh(iou_threshold);
  if (is_small(n, form)) {
    if (n > kSmallMaxBoxes) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = small_smem_bytes(n);
    cudaError_t err = cudaFuncSetAttribute(
        nms_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = n <= 128 ? 128 : 512;
    nms_small_kernel<<<num_problems, threads, smem, s>>>(
        b, sc, v, n, (n + 63) / 64, max_out, t, score_threshold, idx, keep);
    return static_cast<int>(cudaGetLastError());
  }
  if (num_problems > 65535 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch lay = scratch_layout(num_problems, n);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  int* partial = reinterpret_cast<int*>(base + lay.partial);
  float4* sboxes = reinterpret_cast<float4*>(base + lay.sboxes);
  int* sidx = reinterpret_cast<int*>(base + lay.sidx);
  u64* mask = reinterpret_cast<u64*>(base + lay.mask);
  ScanState* state = reinterpret_cast<ScanState*>(base + lay.state);
  const int words = lay.words;

  const dim3 rank_grid((n + kRankThreads * kRankRows - 1) / (kRankThreads * kRankRows),
                       lay.splits, num_problems);
  rank_kernel<<<rank_grid, kRankThreads, 0, s>>>(sc, v, n, score_threshold, lay.splits,
                                                 partial);
  const dim3 order_grid((n + 255) / 256, num_problems);
  order_kernel<<<order_grid, 256, 0, s>>>(b, sc, v, n, score_threshold, lay.splits, partial,
                                          sboxes, sidx, state);
  int band = kFirstBandChunks;
  for (int c0 = 0; c0 < words; band *= 2) {
    const int c1 = c0 + band < words ? c0 + band : words;
    // a band of fewer than 16 blocks an SM takes the narrow blocks: at one
    // problem of 6000 or 3 of 1917 the wide ones leave SMs idle and nearly
    // double the mask's time; at 16 x 6000 the narrow ones add a quarter
    if (static_cast<long long>(words) * (c1 - c0) * num_problems >= 4 * 4 * 132) {
      const dim3 mask_grid((words + 3) / 4, c1 - c0, num_problems);
      mask_kernel<4><<<mask_grid, 64, 0, s>>>(sboxes, sidx, n, words, c0, t, state, mask);
    } else {
      const dim3 mask_grid(words, c1 - c0, num_problems);
      mask_kernel<1><<<mask_grid, 64, 0, s>>>(sboxes, sidx, n, words, c0, t, state, mask);
    }
    scan_kernel<<<num_problems, kScanThreads, 0, s>>>(sidx, mask, n, words, c0, c1,
                                                      c1 == words ? 1 : 0, max_out, state,
                                                      idx, keep);
    c0 = c1;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mtlx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
