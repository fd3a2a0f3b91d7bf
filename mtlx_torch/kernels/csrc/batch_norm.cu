// Train-mode batch norm's work, as two kernels: the paired per-channel
// sums (sum(a), sum(a * b)), which also fold them into the per-channel
// constants of the forward or of the backward, and the per-channel affine
// ((p * a) [+ (q * b)]) + c.
//
// Replaces mtlx/backbones/resnet.py _bn_train (a jax.custom_vjp, :188,
// with _bn_train_fwd :209 and _bn_train_bwd :215), the package's one
// hand-written device op outside the Pallas files. It was written for the
// TPU so that no full-size float32 tensor exists in either direction:
// one variadic reduce, _paired_sums :155, gives (sum(x), sum(x * x)) in
// the forward and (sum(dy), sum(dy * x)) in the backward; a few C-length
// operations make the per-channel constants (:173-185 forward, :218-234
// backward); the output is one elementwise fusion in the compute type,
// y = x * a + c forward and dx = dy * a + x * b + c backward.
//
// What bounds it on Hopper: bytes, and below a few MB the launches. Each
// kernel does 2-4 operations an element it reads. At SSD MobileNet's
// largest batch norm (32 x 64 x 150 x 150 bf16, 92 MB a tensor, above the
// 50 MB L2) a forward + backward must read x, dy and x again at least and
// write y and dx; these kernels read x twice in the forward and dy and x
// in each of the backward's two launches, since the sums must be complete
// before the affine can start. Without data-parallel ranks a direction is
// two launches: the sums with their constants, then the affine. With
// ranks the sums kernel writes only the sums, the ranks add them up, and
// a one-block launch (constants_kernel) computes the same constants.
//
// The sums: one launch, no float atomics, so a call is bit-identical from
// run to run. The grid is persistent, at most kSumsBlocksPerSm blocks of
// kSumsThreads an SM, as many as the card keeps resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); every thread keeps 2-4
// independent 16-byte loads in flight before it adds them. A block adds
// its threads in a fixed tree (lanes by shuffles, then its warps in
// order) and writes one row of float32 partial sums of its tile of
// channels into a workspace [blocks, 2, C] from the caller (PyTorch's
// caching allocator); then an integer ticket per tile (an atomic add with
// acquire and release semantics) picks the tile's last block, which adds
// the rows in index order with all its threads, computes the constants of
// its channels and resets the ticket. The tickets live in a buffer per
// card and stream that the caller zeroes once; the kernel leaves them
// zeroed. A tile of one block skips the workspace and the ticket.
//  - Channels-last memory (NHWC, C innermost; the layout every model takes
//    on the card): a thread owns V consecutive channels (V = 8 bf16 or 4
//    f32, one 16-byte load) and walks rows; a block's threads span its
//    tile of at most kTileChannels channels in x and rows in y, so a warp
//    reads whole 128-byte lines, and a small C over a huge N x H x W
//    (C = 64 at 150 x 150) splits the rows over the blocks. When C is not
//    a multiple of V the rows are not 16-byte aligned: a thread owns
//    kScalarChannels channels and loads them one by one (masked past C).
//  - Contiguous NCHW: a block of kPlanesThreads takes one channel and a
//    share of its N planes (or of plane chunks, where N is small), and
//    walks each range as a scalar head up to the first 16-byte boundary, a
//    body of 16-byte loads and a scalar tail; its channel is its tile. A
//    plane's run is short work, so the grid is kPlaneWaves times what the
//    card keeps resident.
// Each element is read once (a == b, the forward's (x, x), loads once)
// and converted to float32 in registers: no full-size float32 tensor.
//
// The affine. Channels-last with C % V == 0: a block is a whole number of
// rows of C / V threads and the grid strides by a multiple of C, so a
// thread's V channels never change: it loads its constants once, before
// its walk, and each step is 16-byte loads of p (and q), 2-4 in flight,
// the rounded arithmetic and one 16-byte store. NCHW: a block per
// (channel, share of the planes), its constants scalars in registers, the
// runs walked as head, body and tail. Other tensors (C % V != 0, or not
// 16-byte aligned) take a flat walk that steps the channel element by
// element.
//
// Numerics: the sums accumulate float32 in another order than torch.sum
// (within 1e-5 of each channel's sum of term magnitudes on the card,
// chip_smoke.py). The constants repeat the C-length torch ops of the
// plain versions (kernels/batch_norm_cuda.py) in their order, each
// rounded once: a division by the count n is a multiplication by the
// float32 reciprocal of n, as ATen divides a CUDA tensor by a Python
// scalar, and rsqrtf is torch.rsqrt's. The affine evaluates the plain
// version's operations in its order, each rounded to the compute type as
// PyTorch rounds a bf16 tensor op (computed in float32, rounded to nearest
// even): p * a, then + q * b, then + c. Compiled with --fmad=false, the
// affine is bit-equal to the plain version given the same vectors, and
// the constants to the plain version's on the same sums.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // threads of an element-path affine block
constexpr int kBlocksPerSm = 8;       // element-path affine blocks an SM
constexpr int kSumsThreads = 512;     // threads of a sums block
constexpr int kSumsWarps = kSumsThreads / 32;
constexpr int kSumsBlocksPerSm = 2;   // sums blocks an SM at most (the launch bounds' minimum)
constexpr int kTileChannels = 64;     // channels of a channels-last sums tile at most
constexpr int kScalarChannels = 4;    // channels a sums thread owns where rows are unaligned
constexpr int kMinRows = 4;           // rows a sums thread walks at least (channels-last)
constexpr int64_t kMinChunk = 2048;   // elements of a plane chunk at least (NCHW)
constexpr int kPlanesThreads = 256;   // threads of an NCHW sums or affine block
constexpr int kPlanesBlocksPerSm = 8; // NCHW blocks an SM at most
constexpr int kPlaneWaves = 2;        // NCHW blocks an SM's resident blocks take in turn
constexpr int kAffineThreads = 512;   // threads of an affine block at most
constexpr int kAffineBlocksPerSm = 2;
constexpr int kMaxTickets = 65536;    // tiles of a sums launch at most (NCHW: C)

// Element types as their raw bits: float, or bf16 as unsigned short.
template <typename R>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float to_f(float r) { return r; }
  __device__ static float from_f(float v) { return v; }
  __device__ static float round(float v) { return v; }
};

template <>
struct Elem<unsigned short> {
  static constexpr int kVec = 8;
  __device__ static unsigned short load(const unsigned short* p) { return __ldg(p); }
  __device__ static float to_f(unsigned short r) {
    return __uint_as_float(static_cast<unsigned>(r) << 16);
  }
  __device__ static unsigned short from_f(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static float round(float v) { return to_f(from_f(v)); }
};

template <typename R>
union Pack {
  uint4 u;
  R r[Elem<R>::kVec];
};

// V elements at p as raw bits: one 16-byte load (kVec), else element by
// element, 0 past `left`.
template <typename R, bool kVec>
__device__ __forceinline__ Pack<R> load_pack(const R* p, int left) {
  Pack<R> pk;
  if (kVec) {
    pk.u = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int j = 0; j < Elem<R>::kVec; ++j) pk.r[j] = j < left ? Elem<R>::load(p + j) : R(0);
  }
  return pk;
}

// s1 += a, s2 += a * b, element by element in float32
template <typename R, bool kSame>
__device__ __forceinline__ void add_pair(float* s1, float* s2, const Pack<R>& pa,
                                         const Pack<R>& pb) {
#pragma unroll
  for (int j = 0; j < Elem<R>::kVec; ++j) {
    const float va = Elem<R>::to_f(pa.r[j]);
    const float vb = kSame ? va : Elem<R>::to_f(pb.r[j]);
    s1[j] += va;
    s2[j] += va * vb;
  }
}

// The ticket's count before this block's: an integer atomic add with
// acquire and release semantics on the card's scope, so the block's
// partial sums (ordered before it by a barrier) are visible to the block
// that takes the last ticket, and that block reads them after its own.
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// ---- the per-channel constants (_bn_train_impl :173-185, _bn_train_bwd
// :218-234), in the plain versions' order

constexpr int kRaw = 0;       // write the sums [2, C]
constexpr int kForward = 1;   // mean, var, inv [3, C] float32; a = inv, c [2, C]
constexpr int kBackward = 2;  // dgamma, dbeta [2, C] float32; a, b, c [3, C]

struct Epilogue {
  float* out;          // kRaw: sums [2, C]; kForward: [3, C]; kBackward: [2, C]
  void* consts;        // kForward: [2, C]; kBackward: [3, C]; in the tensors' type
  const float* gamma;  // [C]
  const float* beta;   // [C] (kForward)
  const float* mean;   // [C] (kBackward): the forward's statistics
  const float* var;
  const float* inv;
  const float* gmean;  // [C] or null (kBackward): the incoming gradients of mean, var
  const float* gvar;
  const float* local;  // [2, C] or null (kBackward, constants alone): this rank's sums
  float eps;
  long long count;     // elements a channel, over every rank
};

// Channel k's inputs to its constants: gamma and beta (kForward); gamma,
// the forward's mean, var, inv and the incoming gmean, gvar (kBackward).
// Loaded before the sums are complete, so their latency overlaps.
struct ChannelIn {
  float gamma = 0.0f, beta = 0.0f, mean = 0.0f, var = 0.0f, inv = 0.0f, gmean = 0.0f,
        gvar = 0.0f;
};

template <int kMode>
__device__ __forceinline__ ChannelIn load_channel(const Epilogue& e, int k) {
  ChannelIn in;
  if (kMode == kForward) {
    in.gamma = e.gamma[k];
    in.beta = e.beta[k];
  } else if (kMode == kBackward) {
    in.gamma = e.gamma[k];
    in.mean = e.mean[k];
    in.var = e.var[k];
    in.inv = e.inv[k];
    in.gmean = e.gmean ? e.gmean[k] : 0.0f;
    in.gvar = e.gvar ? e.gvar[k] : 0.0f;
  }
  return in;
}

// Channel k's constants from its sums (s1, s2) and, for dgamma and dbeta,
// this rank's sums (l1, l2). Each operation is rounded once (--fmad=false).
template <typename R, int kMode>
__device__ __forceinline__ void finish_channel(const Epilogue& e, int c, int k,
                                               const ChannelIn& in, float s1, float s2,
                                               float l1, float l2) {
  if (kMode == kRaw) {
    e.out[k] = s1;
    e.out[c + k] = s2;
    return;
  }
  R* consts = static_cast<R*>(e.consts);
  const float rn = __fdiv_rn(1.0f, __ll2float_rn(e.count));  // ATen's x / n on the card
  if (kMode == kForward) {
    const float mean = s1 * rn;
    float var = s2 * rn - mean * mean;
    var = isnan(var) ? var : fmaxf(var, 0.0f);  // torch.clamp_min
    const float inv = in.gamma * rsqrtf(var + e.eps);
    e.out[k] = mean;
    e.out[c + k] = var;
    e.out[2 * c + k] = inv;
    consts[k] = Elem<R>::from_f(inv);
    consts[c + k] = Elem<R>::from_f(in.beta - mean * inv);
  } else {
    const float rsig = rsqrtf(in.var + e.eps);
    e.out[k] = rsig * (l2 - in.mean * l1);  // dgamma
    e.out[c + k] = l1;                      // dbeta
    const float stot = s2 - in.mean * s1;
    const float gv = in.gvar - 0.5f * rsig * rsig * rsig * in.gamma * stot;
    const float gmu = in.gmean - in.inv * s1 - 2.0f * in.mean * gv;
    consts[k] = Elem<R>::from_f(in.inv);
    consts[c + k] = Elem<R>::from_f(2.0f * gv * rn);
    consts[2 * c + k] = Elem<R>::from_f(gmu * rn);
  }
}

// ---- the sums: channels-last [rows, C]

template <typename R, bool kVec, bool kSame, int kMode>
__global__ void __launch_bounds__(kSumsThreads, kSumsBlocksPerSm)
sums_rows_kernel(const R* __restrict__ a, const R* __restrict__ b,
                 float* __restrict__ partial,  // [gridDim.x, 2, C]
                 unsigned* __restrict__ tickets, int64_t rows, int c, int tx, Epilogue e) {
  // a thread's channels: one 16-byte load, or kScalarChannels loaded one
  // by one where rows are not 16-byte aligned
  constexpr int V = kVec ? Elem<R>::kVec : kScalarChannels;
  // rows whose loads are in flight before they are added: 64 bytes a
  // thread in bf16, 64-128 in f32, 4 rows of scalar loads
  constexpr int D = kVec && !kSame && V == 8 ? 2 : 4;
  __shared__ float red[2 * kSumsWarps * kTileChannels];
  __shared__ bool last;
  const int ty = kSumsThreads / tx, width = tx * V;  // the tile: width channels
  const int gx = threadIdx.x % tx, gy = threadIdx.x / tx;
  const int c0 = blockIdx.y * width + gx * V;  // this thread's first channel
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.0f;
  if (c0 < c) {
    const int64_t step = static_cast<int64_t>(gridDim.x) * ty;
    const R* pa = a + c0;
    const R* pb = b + c0;
    const int left = c - c0;
    int64_t r = static_cast<int64_t>(blockIdx.x) * ty + gy;
    if constexpr (kVec) {
      for (; r + (D - 1) * step < rows; r += D * step) {
        Pack<R> va[D], vb[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          va[d] = load_pack<R, true>(pa + (r + d * step) * c, left);
          if (!kSame) vb[d] = load_pack<R, true>(pb + (r + d * step) * c, left);
        }
#pragma unroll
        for (int d = 0; d < D; ++d) add_pair<R, kSame>(s1, s2, va[d], kSame ? va[d] : vb[d]);
      }
    } else {  // the elements as floats, 0 past C: every lane loads, from a channel below C
      for (; r + (D - 1) * step < rows; r += D * step) {
        float va[D][V], vb[D][V];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int64_t row = (r + d * step) * c;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int k = j < left ? j : left - 1;
            va[d][j] = Elem<R>::to_f(Elem<R>::load(pa + row + k));
            vb[d][j] = kSame ? va[d][j] : Elem<R>::to_f(Elem<R>::load(pb + row + k));
          }
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            if (j >= left) va[d][j] = vb[d][j] = 0.0f;
          }
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            s1[j] += va[d][j];
            s2[j] += va[d][j] * vb[d][j];
          }
        }
      }
    }
    for (; r < rows; r += step) {
      if constexpr (kVec) {
        const Pack<R> va = load_pack<R, true>(pa + r * c, left);
        add_pair<R, kSame>(s1, s2, va, kSame ? va : load_pack<R, true>(pb + r * c, left));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float va = j < left ? Elem<R>::to_f(Elem<R>::load(pa + r * c + j)) : 0.0f;
          const float vb = kSame ? va : j < left ? Elem<R>::to_f(Elem<R>::load(pb + r * c + j))
                                                 : 0.0f;
          s1[j] += va;
          s2[j] += va * vb;
        }
      }
    }
  }
  // the block's rows in a fixed tree: a warp's rows (lanes tx apart) by
  // shuffles, then the warps in order
  for (int o = tx; o < 32; o *= 2) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], o);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], o);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < tx) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[warp * kTileChannels + lane * V + j] = s1[j];
      red[(kSumsWarps + warp) * kTileChannels + lane * V + j] = s2[j];
    }
  }
  __syncthreads();
  const int cols = 2 * width;  // (s1, s2) of each channel of the tile
  float t = 0.0f;
  if (threadIdx.x < cols) {
    const int stat = threadIdx.x / width, col = threadIdx.x % width;
    for (int w = 0; w < kSumsWarps; ++w) t += red[(stat * kSumsWarps + w) * kTileChannels + col];
    const int ch = blockIdx.y * width + col;
    if (gridDim.x > 1 && ch < c)
      partial[(static_cast<int64_t>(blockIdx.x) * 2 + stat) * c + ch] = t;
  }
  if (gridDim.x == 1) {  // the tile's only block: its totals are the tile's
    __syncthreads();
    if (threadIdx.x < cols) red[threadIdx.x] = t;
    __syncthreads();
    const int ch = blockIdx.y * width + threadIdx.x;
    if (threadIdx.x < width && ch < c) {
      const float t1 = red[threadIdx.x], t2 = red[width + threadIdx.x];
      finish_channel<R, kMode>(e, c, ch, load_channel<kMode>(e, ch), t1, t2, t1, t2);
    }
    return;
  }
  // the barrier orders the block's writes before thread 0's ticket, whose
  // release makes them visible on the card (cumulativity); its acquire
  // and the barrier order the last block's reads after every other's
  __syncthreads();
  if (threadIdx.x == 0) last = take_ticket(tickets + blockIdx.y) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the tile's last block: each column's partial rows in index order over
  // `groups` threads, then those threads' totals in order
  const int mine = blockIdx.y * width + threadIdx.x;  // the channel a thread finishes
  const ChannelIn in = threadIdx.x < width && mine < c ? load_channel<kMode>(e, mine)
                                                       : ChannelIn();
  const int groups = kSumsThreads / cols;
  {
    const int k = threadIdx.x % cols, g = threadIdx.x / cols;
    const int ch = blockIdx.y * width + k % width;
    float total = 0.0f;
    if (ch < c) {
      const float* p = partial + static_cast<int64_t>(k / width) * c + ch;
      const int64_t rs = 2 * static_cast<int64_t>(c);
      const int blocks = gridDim.x;
      constexpr int kLoads = 32;  // partial rows in flight, 0 past the last
      for (int i = g; i < blocks; i += kLoads * groups) {
        float v[kLoads];
#pragma unroll
        for (int d = 0; d < kLoads; ++d)
          v[d] = i + d * groups < blocks ? __ldcg(p + (i + d * groups) * rs) : 0.0f;
#pragma unroll
        for (int d = 0; d < kLoads; ++d) total += v[d];
      }
    }
    red[threadIdx.x] = total;  // = red[g * cols + k]
  }
  __syncthreads();
  if (threadIdx.x < width && mine < c) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int g = 0; g < groups; ++g) {
      t1 += red[g * cols + threadIdx.x];
      t2 += red[g * cols + width + threadIdx.x];
    }
    finish_channel<R, kMode>(e, c, mine, in, t1, t2, t1, t2);
  }
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

// ---- the sums: contiguous NCHW [n, C, inner]

// thread 0 gets the block's sum of v, in a fixed order
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kPlanesThreads / 32; ++w) t += scratch[w];
  }
  __syncthreads();
  return t;
}

template <typename R, bool kSame, int kMode>
__global__ void __launch_bounds__(kPlanesThreads)
sums_planes_kernel(const R* __restrict__ a, const R* __restrict__ b,
                   float* __restrict__ partial,  // [gridDim.x, 2, C]
                   unsigned* __restrict__ tickets, int n, int c, int64_t inner, int chunks,
                   int vec, Epilogue e) {
  constexpr int V = Elem<R>::kVec;
  __shared__ float scratch[kPlanesThreads / 32];
  __shared__ bool last;
  const int ch = blockIdx.y;
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.0f;
  const int64_t items = static_cast<int64_t>(n) * chunks;
  for (int64_t w = blockIdx.x; w < items; w += gridDim.x) {
    const int64_t plane = w / chunks, k = w % chunks;
    const int64_t lo = inner * k / chunks, hi = inner * (k + 1) / chunks;
    const int64_t base = (plane * c + ch) * inner;
    const R* pa = a + base;
    const R* pb = b + base;
    // [body, end): 16-byte loads, two in flight; [lo, body) and [end, hi): one by one
    int64_t body = lo, end = lo;
    if (vec) {
      const uintptr_t addr = reinterpret_cast<uintptr_t>(pa + lo);
      const int64_t head = static_cast<int64_t>((16 - addr % 16) % 16) / sizeof(R);
      body = lo + head < hi ? lo + head : hi;
      end = body + (hi - body) / V * V;
    }
    constexpr int64_t kStep = static_cast<int64_t>(kPlanesThreads) * V;
    int64_t i = body + static_cast<int64_t>(threadIdx.x) * V;
    for (; i + kStep < end; i += 2 * kStep) {
      const Pack<R> a0 = load_pack<R, true>(pa + i, V), a1 = load_pack<R, true>(pa + i + kStep, V);
      if (kSame) {
        add_pair<R, true>(s1, s2, a0, a0);
        add_pair<R, true>(s1, s2, a1, a1);
      } else {
        const Pack<R> b0 = load_pack<R, true>(pb + i, V);
        const Pack<R> b1 = load_pack<R, true>(pb + i + kStep, V);
        add_pair<R, false>(s1, s2, a0, b0);
        add_pair<R, false>(s1, s2, a1, b1);
      }
    }
    for (; i < end; i += kStep) {
      const Pack<R> a0 = load_pack<R, true>(pa + i, V);
      add_pair<R, kSame>(s1, s2, a0, kSame ? a0 : load_pack<R, true>(pb + i, V));
    }
    for (int64_t j = lo + threadIdx.x; j < body; j += kPlanesThreads) {
      const float va = Elem<R>::to_f(Elem<R>::load(pa + j));
      const float vb = kSame ? va : Elem<R>::to_f(Elem<R>::load(pb + j));
      s1[0] += va;
      s2[0] += va * vb;
    }
    for (int64_t j = end + threadIdx.x; j < hi; j += kPlanesThreads) {
      const float va = Elem<R>::to_f(Elem<R>::load(pa + j));
      const float vb = kSame ? va : Elem<R>::to_f(Elem<R>::load(pb + j));
      s1[0] += va;
      s2[0] += va * vb;
    }
  }
  float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    t1 += s1[j];
    t2 += s2[j];
  }
  t1 = block_sum(t1, scratch);
  t2 = block_sum(t2, scratch);
  if (threadIdx.x == 0) {
    float* out = partial + static_cast<int64_t>(blockIdx.x) * 2 * c;
    out[ch] = t1;
    out[c + ch] = t2;
    last = take_ticket(tickets + ch) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the channel's last block: the partial rows, a warp's lanes in index
  // order each, then the lanes in a fixed tree
  if (threadIdx.x < 32) {
    float u1 = 0.0f, u2 = 0.0f;
    for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += 32) {
      u1 += __ldcg(partial + static_cast<int64_t>(i) * 2 * c + ch);
      u2 += __ldcg(partial + (static_cast<int64_t>(i) * 2 + 1) * c + ch);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      u1 += __shfl_xor_sync(0xffffffffu, u1, o);
      u2 += __shfl_xor_sync(0xffffffffu, u2, o);
    }
    if (threadIdx.x == 0) {
      finish_channel<R, kMode>(e, c, ch, load_channel<kMode>(e, ch), u1, u2, u1, u2);
      tickets[ch] = 0;
    }
  }
}

// ---- the constants alone, from sums [2, C] that the ranks added up: one block

template <typename R, int kMode>
__global__ void __launch_bounds__(kSumsThreads)
constants_kernel(const float* __restrict__ sums, int c, Epilogue e) {
  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    const float s1 = sums[k], s2 = sums[c + k];
    const float l1 = e.local ? e.local[k] : s1, l2 = e.local ? e.local[c + k] : s2;
    finish_channel<R, kMode>(e, c, k, load_channel<kMode>(e, k), s1, s2, l1, l2);
  }
}

// ---- the affine: out = ((p * a) [+ (q * b)]) + c, per channel

template <typename R, bool kQ>
__device__ __forceinline__ R affine_one(R p, R q, float a, float b, float c) {
  float y = Elem<R>::round(Elem<R>::to_f(p) * a);
  if (kQ) y = Elem<R>::round(y + Elem<R>::round(Elem<R>::to_f(q) * b));
  return Elem<R>::from_f(y + c);
}

template <typename R, bool kQ>
__device__ __forceinline__ uint4 affine_pack(const Pack<R>& pp, const Pack<R>& pq,
                                             const float* a, const float* b, const float* c) {
  Pack<R> o;
#pragma unroll
  for (int j = 0; j < Elem<R>::kVec; ++j)
    o.r[j] = affine_one<R, kQ>(pp.r[j], pq.r[j], a[j], kQ ? b[j] : 0.0f, c[j]);
  return o.u;
}

// channels-last, C % V == 0, 16-byte aligned: vector i holds channels
// (i % groups) * V .. + V; blockDim.x and so the stride are multiples of
// groups, so a thread's channels are fixed
template <typename R, bool kQ>
__global__ void __launch_bounds__(kAffineThreads, kAffineBlocksPerSm)
affine_rows_kernel(const R* __restrict__ p, const R* __restrict__ q, const R* __restrict__ va,
                   const R* __restrict__ vb, const R* __restrict__ vc, R* __restrict__ out,
                   int64_t nvec, int groups) {
  constexpr int V = Elem<R>::kVec;
  constexpr int D = kQ ? 2 : 4;  // vectors whose loads are in flight at once
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int g = static_cast<int>(i % groups);
  float fa[V], fb[V], fc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    fa[j] = Elem<R>::to_f(Elem<R>::load(va + g * V + j));
    fb[j] = kQ ? Elem<R>::to_f(Elem<R>::load(vb + g * V + j)) : 0.0f;
    fc[j] = Elem<R>::to_f(Elem<R>::load(vc + g * V + j));
  }
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
  const uint4* q4 = reinterpret_cast<const uint4*>(q);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  for (; i + (D - 1) * stride < nvec; i += D * stride) {
    Pack<R> pp[D], pq[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      pp[d].u = __ldg(p4 + i + d * stride);
      if (kQ) pq[d].u = __ldg(q4 + i + d * stride);
    }
#pragma unroll
    for (int d = 0; d < D; ++d)
      o4[i + d * stride] = affine_pack<R, kQ>(pp[d], kQ ? pq[d] : pp[d], fa, fb, fc);
  }
  for (; i < nvec; i += stride) {
    Pack<R> pp, pq;
    pp.u = __ldg(p4 + i);
    pq.u = kQ ? __ldg(q4 + i) : pp.u;
    o4[i] = affine_pack<R, kQ>(pp, pq, fa, fb, fc);
  }
}

// contiguous NCHW: a block per (channel, share of the planes or plane
// chunks); a 16-byte body where p, q and out are 16-byte aligned
template <typename R, bool kQ>
__global__ void __launch_bounds__(kPlanesThreads)
affine_planes_kernel(const R* __restrict__ p, const R* __restrict__ q, const R* __restrict__ va,
                     const R* __restrict__ vb, const R* __restrict__ vc, R* __restrict__ out,
                     int n, int c, int64_t inner, int chunks, int vec) {
  constexpr int V = Elem<R>::kVec;
  const int ch = blockIdx.y;
  const float a = Elem<R>::to_f(Elem<R>::load(va + ch));
  const float b = kQ ? Elem<R>::to_f(Elem<R>::load(vb + ch)) : 0.0f;
  const float cc = Elem<R>::to_f(Elem<R>::load(vc + ch));
  float fa[V], fb[V], fc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    fa[j] = a;
    fb[j] = b;
    fc[j] = cc;
  }
  const int64_t items = static_cast<int64_t>(n) * chunks;
  for (int64_t w = blockIdx.x; w < items; w += gridDim.x) {
    const int64_t plane = w / chunks, k = w % chunks;
    const int64_t lo = inner * k / chunks, hi = inner * (k + 1) / chunks;
    const int64_t base = (plane * c + ch) * inner;
    const R* pp = p + base;
    const R* qq = kQ ? q + base : pp;
    R* oo = out + base;
    int64_t body = lo, end = lo;
    if (vec) {
      const uintptr_t addr = reinterpret_cast<uintptr_t>(pp + lo);
      const int64_t head = static_cast<int64_t>((16 - addr % 16) % 16) / sizeof(R);
      body = lo + head < hi ? lo + head : hi;
      end = body + (hi - body) / V * V;
    }
    for (int64_t i = body + static_cast<int64_t>(threadIdx.x) * V; i < end;
         i += static_cast<int64_t>(blockDim.x) * V) {
      Pack<R> lp, lq;
      lp.u = __ldg(reinterpret_cast<const uint4*>(pp + i));
      lq.u = kQ ? __ldg(reinterpret_cast<const uint4*>(qq + i)) : lp.u;
      *reinterpret_cast<uint4*>(oo + i) = affine_pack<R, kQ>(lp, lq, fa, fb, fc);
    }
    for (int64_t i = lo + threadIdx.x; i < body; i += blockDim.x)
      oo[i] = affine_one<R, kQ>(Elem<R>::load(pp + i), Elem<R>::load(qq + i), a, b, cc);
    for (int64_t i = end + threadIdx.x; i < hi; i += blockDim.x)
      oo[i] = affine_one<R, kQ>(Elem<R>::load(pp + i), Elem<R>::load(qq + i), a, b, cc);
  }
}

// any dense layout and C: a flat walk in groups of V elements that tracks
// the channel of each element
template <typename R, bool kQ, bool kVec>
__global__ void __launch_bounds__(kThreads)
affine_kernel(const R* __restrict__ p, const R* __restrict__ q, const R* __restrict__ va,
              const R* __restrict__ vb, const R* __restrict__ vc, R* __restrict__ out,
              int64_t numel, int c, int64_t inner, int64_t step_pos, int step_ch) {
  constexpr int V = Elem<R>::kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * V;  // elements
  int64_t e = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  // (position inside the channel's run, channel) of e; then stepped by stride
  int64_t pos = e % inner;
  int ch = static_cast<int>((e / inner) % c);
  for (; e < numel; e += stride) {
    const int64_t left = numel - e;
    const bool full = kVec && left >= V;
    Pack<R> pp, pq;
    if (full) {
      pp = load_pack<R, true>(p + e, V);
      if (kQ) pq = load_pack<R, true>(q + e, V);
    } else {
      const int l = left < V ? static_cast<int>(left) : V;
      pp = load_pack<R, false>(p + e, l);
      if (kQ) pq = load_pack<R, false>(q + e, l);
    }
    Pack<R> pk;
    int64_t pj = pos;
    int cj = ch;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      pk.r[j] = affine_one<R, kQ>(pp.r[j], kQ ? pq.r[j] : pp.r[j],
                                  Elem<R>::to_f(Elem<R>::load(va + cj)),
                                  kQ ? Elem<R>::to_f(Elem<R>::load(vb + cj)) : 0.0f,
                                  Elem<R>::to_f(Elem<R>::load(vc + cj)));
      if (++pj == inner) {
        pj = 0;
        if (++cj == c) cj = 0;
      }
    }
    if (full) {
      *reinterpret_cast<uint4*>(out + e) = pk.u;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (j < left) out[e + j] = pk.r[j];
    }
    pos += step_pos;
    int carry = 0;
    if (pos >= inner) {
      pos -= inner;
      carry = 1;
    }
    ch += step_ch + carry;
    if (ch >= c) ch -= c;
  }
}

// ---- host side

int sm_count() {
  static int cached[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 132;
  if (device >= 0 && device < 64 && cached[device] > 0) return cached[device];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms <= 0)
    sms = 132;
  if (device >= 0 && device < 64) cached[device] = sms;
  return sms;
}

// blocks of `threads` the card keeps resident on an SM, at most `cap`
template <typename K>
int resident(K kernel, int threads, int cap) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0) != cudaSuccess ||
      blocks < 1)
    blocks = 1;
  return blocks < cap ? blocks : cap;
}

// The sums' grid follows the raw-sums instance of each walk, so every
// mode adds in the same order and their sums agree bit for bit.
template <typename R, bool kVec, bool kSame>
int rows_blocks_per_sm() {
  static const int blocks =
      resident(sums_rows_kernel<R, kVec, kSame, kRaw>, kSumsThreads, kSumsBlocksPerSm);
  return blocks;
}

template <typename R, bool kSame>
int planes_blocks_per_sm() {
  static const int blocks =
      resident(sums_planes_kernel<R, kSame, kRaw>, kPlanesThreads, kPlanesBlocksPerSm);
  return blocks;
}

// The grid of a sums launch: its blocks in x (the rows of the workspace)
// and y (the tiles), the tile's thread width tx (channels-last, v
// channels a thread) or the chunks a plane is cut into (NCHW), for
// blocks_per_sm blocks an SM.
struct SumsGrid {
  dim3 grid;
  int tx = 0;
  int chunks = 0;
};

SumsGrid sums_grid(int layout, int64_t n, int c, int64_t inner, int v, int blocks_per_sm) {
  SumsGrid g;
  const int64_t target = static_cast<int64_t>(sm_count()) * blocks_per_sm;
  if (layout == 0) {  // channels-last: rows = n * inner, v channels a thread
    const int64_t rows = n * inner;
    const int groups = (c + v - 1) / v;
    int tx = 1;
    while (tx < groups && tx * v < kTileChannels) tx *= 2;
    const int ty = kSumsThreads / tx;
    const int tiles = (groups + tx - 1) / tx;
    int64_t gx = target / tiles;
    const int64_t most = (rows + static_cast<int64_t>(ty) * kMinRows - 1) /
                         (static_cast<int64_t>(ty) * kMinRows);
    if (gx > most) gx = most;
    if (gx < 1) gx = 1;
    g.grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(tiles), 1);
    g.tx = tx;
  } else {  // NCHW: a block per (channel, share of the planes or plane chunks), in
            // kPlaneWaves waves of short blocks, since a plane's run is short work
    const int64_t want = (target * kPlaneWaves + c - 1) / c;
    int64_t chunks = (want + n - 1) / n;
    const int64_t most_chunks = inner / kMinChunk > 1 ? inner / kMinChunk : 1;
    if (chunks > most_chunks) chunks = most_chunks;
    if (chunks < 1) chunks = 1;
    int64_t splits = want < n * chunks ? want : n * chunks;
    if (splits < 1) splits = 1;
    g.grid = dim3(static_cast<unsigned>(splits), static_cast<unsigned>(c), 1);
    g.chunks = static_cast<int>(chunks);
  }
  return g;
}

bool valid_shape(int layout, long long n, int c, long long inner, int dtype) {
  return (layout == 0 || layout == 1) && (dtype == 0 || dtype == 1) && n >= 0 && c > 0 &&
         inner >= 0 && c < kMaxTickets && n <= 0x7fffffffLL;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename R, bool kVec, bool kSame, int kMode>
void launch_rows(const R* a, const R* b, float* work, unsigned* tickets, int64_t rows, int c,
                 const Epilogue& e, cudaStream_t s) {
  const SumsGrid g = sums_grid(0, rows, c, 1, kVec ? Elem<R>::kVec : kScalarChannels,
                               rows_blocks_per_sm<R, kVec, kSame>());
  sums_rows_kernel<R, kVec, kSame, kMode>
      <<<g.grid, kSumsThreads, 0, s>>>(a, b, work, tickets, rows, c, g.tx, e);
}

template <typename R, bool kSame, int kMode>
void launch_planes(const R* a, const R* b, float* work, unsigned* tickets, int64_t n, int c,
                   int64_t inner, const Epilogue& e, cudaStream_t s) {
  const SumsGrid g = sums_grid(1, n, c, inner, 0, planes_blocks_per_sm<R, kSame>());
  // the same offset from a 16-byte boundary at every index of a and b
  const int vec = (reinterpret_cast<uintptr_t>(a) - reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  sums_planes_kernel<R, kSame, kMode><<<g.grid, kPlanesThreads, 0, s>>>(
      a, b, work, tickets, static_cast<int>(n), c, inner, g.chunks, vec, e);
}

template <typename R, int kMode>
int launch_sums(const void* a_, const void* b_, float* work, unsigned* tickets, int layout,
                int64_t n, int c, int64_t inner, const Epilogue& e, cudaStream_t s) {
  const R* a = static_cast<const R*>(a_);
  const R* b = static_cast<const R*>(b_);
  if (n * inner == 0) {  // no elements: sums of 0
    if (kMode == kRaw) return static_cast<int>(cudaMemsetAsync(e.out, 0, sizeof(float) * 2 * c, s));
    const int err = static_cast<int>(cudaMemsetAsync(work, 0, sizeof(float) * 2 * c, s));
    if (err != 0) return err;
    constants_kernel<R, kMode><<<1, kSumsThreads, 0, s>>>(work, c, e);
    return static_cast<int>(cudaGetLastError());
  }
  const bool same = a == b;
  if (layout == 0) {
    const bool vec = c % Elem<R>::kVec == 0 && aligned16(a) && aligned16(b);
    const int64_t rows = n * inner;
    if (vec && same)
      launch_rows<R, true, true, kMode>(a, b, work, tickets, rows, c, e, s);
    else if (vec)
      launch_rows<R, true, false, kMode>(a, b, work, tickets, rows, c, e, s);
    else if (same)
      launch_rows<R, false, true, kMode>(a, b, work, tickets, rows, c, e, s);
    else
      launch_rows<R, false, false, kMode>(a, b, work, tickets, rows, c, e, s);
  } else if (same) {
    launch_planes<R, true, kMode>(a, b, work, tickets, n, c, inner, e, s);
  } else {
    launch_planes<R, false, kMode>(a, b, work, tickets, n, c, inner, e, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int sums_by_type(const void* a, const void* b, void* work, void* tickets, int layout, long long n,
                 int c, long long hw, int dtype, const Epilogue& e, void* stream) {
  if (!valid_shape(layout, n, c, hw, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  unsigned* t = static_cast<unsigned*>(tickets);
  if (dtype == 0) return launch_sums<float, kMode>(a, b, w, t, layout, n, c, hw, e, s);
  return launch_sums<unsigned short, kMode>(a, b, w, t, layout, n, c, hw, e, s);
}

template <int kMode>
int constants_by_type(const void* sums, int c, int dtype, const Epilogue& e, void* stream) {
  if (c <= 0 || c >= kMaxTickets || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(sums);
  if (dtype == 0)
    constants_kernel<float, kMode><<<1, kSumsThreads, 0, s>>>(f, c, e);
  else
    constants_kernel<unsigned short, kMode><<<1, kSumsThreads, 0, s>>>(f, c, e);
  return static_cast<int>(cudaGetLastError());
}

template <typename R, bool kQ>
int affine_rows_blocks_per_sm() {
  static const int blocks =
      resident(affine_rows_kernel<R, kQ>, kAffineThreads, kAffineBlocksPerSm);
  return blocks;
}

template <typename R, bool kQ>
int affine_planes_blocks_per_sm() {
  static const int blocks =
      resident(affine_planes_kernel<R, kQ>, kPlanesThreads, kPlanesBlocksPerSm);
  return blocks;
}

template <typename R, bool kQ>
void launch_affine_as(const R* p, const R* q, const R* va, const R* vb, const R* vc, R* out,
                      int layout, int64_t n, int c, int64_t hw, bool vec, cudaStream_t s) {
  constexpr int V = Elem<R>::kVec;
  const int64_t numel = n * c * hw;
  if (layout == 0 && vec && c % V == 0 && c / V <= kAffineThreads) {
    const int groups = c / V;
    const int threads = kAffineThreads / groups * groups;
    const int64_t nvec = numel / V;
    int64_t blocks = (nvec + threads - 1) / threads;
    const int64_t most = static_cast<int64_t>(sm_count()) * affine_rows_blocks_per_sm<R, kQ>();
    if (blocks > most) blocks = most;
    affine_rows_kernel<R, kQ><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        p, q, va, vb, vc, out, nvec, groups);
  } else if (layout == 1) {
    const SumsGrid g = sums_grid(1, n, c, hw, 0,
                                 affine_planes_blocks_per_sm<R, kQ>());  // the sums' NCHW split
    affine_planes_kernel<R, kQ><<<g.grid, kPlanesThreads, 0, s>>>(
        p, q, va, vb, vc, out, static_cast<int>(n), c, hw, g.chunks, vec ? 1 : 0);
  } else {
    const int64_t inner = layout == 0 ? 1 : hw;
    const int64_t groups = (numel + V - 1) / V;
    int64_t blocks = (groups + kThreads - 1) / kThreads;
    const int64_t most = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
    if (blocks > most) blocks = most;
    const int64_t stride = blocks * kThreads * V;
    const int64_t step_pos = stride % inner;
    const int step_ch = static_cast<int>((stride / inner) % c);
    const dim3 grid(static_cast<unsigned>(blocks));
    if (vec)
      affine_kernel<R, kQ, true><<<grid, kThreads, 0, s>>>(p, q, va, vb, vc, out, numel, c,
                                                           inner, step_pos, step_ch);
    else
      affine_kernel<R, kQ, false><<<grid, kThreads, 0, s>>>(p, q, va, vb, vc, out, numel, c,
                                                            inner, step_pos, step_ch);
  }
}

template <typename R>
int launch_affine(const void* p_, const void* q_, const void* a_, const void* b_,
                  const void* c_, void* out_, int layout, int64_t n, int c, int64_t hw,
                  cudaStream_t s) {
  const R* p = static_cast<const R*>(p_);
  const R* q = static_cast<const R*>(q_);
  const R* va = static_cast<const R*>(a_);
  const R* vb = static_cast<const R*>(b_);
  const R* vc = static_cast<const R*>(c_);
  R* out = static_cast<R*>(out_);
  const bool vec = aligned16(p) && aligned16(out) && (q == nullptr || aligned16(q));
  if (q != nullptr)
    launch_affine_as<R, true>(p, q, va, vb, vc, out, layout, n, c, hw, vec, s);
  else
    launch_affine_as<R, false>(p, q, va, vb, vc, out, layout, n, c, hw, vec, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tensors are [n, C, H, W] with hw = H * W, in one of two dense layouts:
// layout 0 = channels-last memory (NHWC), 1 = contiguous NCHW. dtype 0 =
// float32, 1 = bfloat16; the per-channel statistics are float32 [C]
// vectors. A sums call takes a workspace of mtlx_bn_sums_workspace floats
// and tickets, an int32 buffer of mtlx_bn_tickets() entries that is zero
// before the first call on a stream and that every call leaves zero. Each
// launcher makes one launch and returns cudaGetLastError() after it (0 on
// success).

extern "C" int mtlx_bn_tickets() { return kMaxTickets; }

// The float32 elements of the workspace a sums call needs.
extern "C" long long mtlx_bn_sums_workspace(int layout, long long n, int c, long long hw,
                                            int dtype) {
  if (!valid_shape(layout, n, c, hw, dtype)) return 0;
  if (n * hw == 0) return 2LL * c;
  // the most blocks of either channels-last walk (16-byte loads or scalar)
  long long blocks = 0;
  const int widths[2] = {dtype == 1 ? 8 : 4, kScalarChannels};
  for (const int v : widths) {
    const long long b =
        sums_grid(layout, n, c, hw, v, layout == 0 ? kSumsBlocksPerSm : kPlanesBlocksPerSm).grid.x;
    blocks = b > blocks ? b : blocks;
  }
  return blocks * 2 * c;
}

// out [2, C] float32 = (sum of a, sum of a * b) per channel; a and b in
// one layout and type.
extern "C" int mtlx_bn_paired_sums(const void* a, const void* b, void* work, void* tickets,
                                   void* out, int layout, long long n, int c, long long hw,
                                   int dtype, void* stream) {
  Epilogue e{};
  e.out = static_cast<float*>(out);
  return sums_by_type<kRaw>(a, b, work, tickets, layout, n, c, hw, dtype, e, stream);
}

// The forward of _bn_train from x: stats [3, C] float32 = (mean, var,
// inv) and consts [2, C] in x's type = (inv, beta - mean * inv), with
// count elements a channel.
extern "C" int mtlx_bn_forward_sums(const void* x, void* work, void* tickets, const void* gamma,
                                    const void* beta, float eps, long long count, void* stats,
                                    void* consts, int layout, long long n, int c, long long hw,
                                    int dtype, void* stream) {
  Epilogue e{};
  e.out = static_cast<float*>(stats);
  e.consts = consts;
  e.gamma = static_cast<const float*>(gamma);
  e.beta = static_cast<const float*>(beta);
  e.eps = eps;
  e.count = count;
  return sums_by_type<kForward>(x, x, work, tickets, layout, n, c, hw, dtype, e, stream);
}

// The backward's sums of (dy, x) and its constants: grads [2, C] float32
// = (dgamma, dbeta) and consts [3, C] in x's type = (a, b, c) of dx = dy *
// a + x * b + c; gmean and gvar may be null (no gradient).
extern "C" int mtlx_bn_backward_sums(const void* dy, const void* x, void* work, void* tickets,
                                     const void* mean, const void* var, const void* inv,
                                     const void* gamma, const void* gmean, const void* gvar,
                                     float eps, long long count, void* grads, void* consts,
                                     int layout, long long n, int c, long long hw, int dtype,
                                     void* stream) {
  Epilogue e{};
  e.out = static_cast<float*>(grads);
  e.consts = consts;
  e.gamma = static_cast<const float*>(gamma);
  e.mean = static_cast<const float*>(mean);
  e.var = static_cast<const float*>(var);
  e.inv = static_cast<const float*>(inv);
  e.gmean = static_cast<const float*>(gmean);
  e.gvar = static_cast<const float*>(gvar);
  e.eps = eps;
  e.count = count;
  return sums_by_type<kBackward>(dy, x, work, tickets, layout, n, c, hw, dtype, e, stream);
}

// mtlx_bn_forward_sums' outputs from sums [2, C] that are already
// complete (added over the ranks): one block.
extern "C" int mtlx_bn_forward_constants(const void* sums, const void* gamma, const void* beta,
                                         float eps, long long count, void* stats, void* consts,
                                         int c, int dtype, void* stream) {
  Epilogue e{};
  e.out = static_cast<float*>(stats);
  e.consts = consts;
  e.gamma = static_cast<const float*>(gamma);
  e.beta = static_cast<const float*>(beta);
  e.eps = eps;
  e.count = count;
  return constants_by_type<kForward>(sums, c, dtype, e, stream);
}

// mtlx_bn_backward_sums' outputs from the ranks' sums [2, C], with dgamma
// and dbeta from this rank's sums `local` [2, C]: one block.
extern "C" int mtlx_bn_backward_constants(const void* sums, const void* local, const void* mean,
                                          const void* var, const void* inv, const void* gamma,
                                          const void* gmean, const void* gvar, float eps,
                                          long long count, void* grads, void* consts, int c,
                                          int dtype, void* stream) {
  Epilogue e{};
  e.out = static_cast<float*>(grads);
  e.consts = consts;
  e.gamma = static_cast<const float*>(gamma);
  e.mean = static_cast<const float*>(mean);
  e.var = static_cast<const float*>(var);
  e.inv = static_cast<const float*>(inv);
  e.gmean = static_cast<const float*>(gmean);
  e.gvar = static_cast<const float*>(gvar);
  e.local = static_cast<const float*>(local);
  e.eps = eps;
  e.count = count;
  return constants_by_type<kBackward>(sums, c, dtype, e, stream);
}

// out = ((p * a) + (q * b)) + c, or (p * a) + c where q is null, with
// per-channel vectors a, b, c [C] in the tensors' type; out in p's
// layout.
extern "C" int mtlx_bn_affine(const void* p, const void* q, const void* a, const void* b,
                              const void* c_vec, void* out, int layout, long long n, int c,
                              long long hw, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_shape(layout, n, c, hw, dtype) || (q != nullptr && b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n * hw == 0) return 0;
  if (dtype == 0)
    return launch_affine<float>(p, q, a, b, c_vec, out, layout, n, c, hw, s);
  return launch_affine<unsigned short>(p, q, a, b, c_vec, out, layout, n, c, hw, s);
}

extern "C" const char* mtlx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
