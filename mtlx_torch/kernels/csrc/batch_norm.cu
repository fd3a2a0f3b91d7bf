// Train-mode batch norm's full-size work, as two kernels: the paired
// per-channel sums (sum(a), sum(a * b)) and the folded per-channel affine
// ((p * a) [+ (q * b)]) + c.
//
// Replaces mtlx/backbones/resnet.py _bn_train (a jax.custom_vjp, :187,
// with _bn_train_fwd :208 and _bn_train_bwd :214), the package's one
// hand-written device op outside the Pallas files. It was written for the
// TPU so that no full-size float32 tensor exists in either direction:
// one variadic reduce, _paired_sums :155, gives (sum(x), sum(x * x)) in
// the forward and (sum(dy), sum(dy * x)) in the backward, and the output
// is one elementwise fusion in the compute type, y = x * a + c forward and
// dx = dy * a + x * b + c backward, with per-channel constants a, b, c.
// The two kernels keep that split; the per-channel constants between them
// (and the all-reduce of the sums over data-parallel ranks) stay C-length
// torch ops in mtlx_torch/backbones/resnet.py _BatchNormTrain.
//
// What bounds it on Hopper: bytes. Each kernel does 2-4 operations an
// element it reads. At SSD MobileNet's largest batch norm (32 x 64 x 150
// x 150 bf16, 92 MB a tensor, above the 50 MB L2) a forward + backward
// must read x, dy and x again at least and write y and dx: five passes,
// 0.138 ms at 3.35 TB/s. These kernels make eight (x twice in the
// forward; dy and x in each of the backward's two launches), since the
// sums must be complete before the affine can start.
//
// paired_sums. Two levels, no float atomics, so a call is bit-identical
// from run to run. Level one: every block reduces its share of the
// elements into float32 per-channel partial sums, written to a workspace
// [blocks, 2, C] that the caller allocates (PyTorch's caching allocator,
// current stream; mtlx_bn_sums_workspace gives its size). Level two
// (sums_finish_kernel) adds the partials of each channel in a fixed tree.
// The grid covers the card (8 blocks of 256 threads per SM) whatever C
// is: a small C over a huge N x H x W (C = 32 or 64 at 150 x 150) splits
// the rows, not the channels, over the blocks.
//  - Channels-last memory (NHWC, C innermost; the layout every model takes
//    on the card): a thread owns V consecutive channels (V = 8 bf16 or 4
//    f32, one 16-byte load) and walks rows; a block's threads span its
//    tile of channels in x and rows in y, so a warp reads whole rows, and
//    the block adds its y threads in shared memory at the end. When C is
//    not a multiple of V the rows are not 16-byte aligned and the same
//    walk loads each thread's V channels one by one (masked past C).
//  - Contiguous NCHW: a block takes one channel and a share of its N
//    planes (or of plane chunks, where N is small), and walks each range
//    as a scalar head up to the first 16-byte boundary, a body of 16-byte
//    loads and a scalar tail.
// Each element is read once (a == b, the forward's (x, x), loads once)
// and converted to float32 in registers: no full-size float32 tensor.
//
// bn_affine. A flat walk over the tensor in groups of V elements, one
// 16-byte load of p (and q) and one 16-byte store a group where every
// pointer is 16-byte aligned, element by element for the last, partial
// group and for unaligned tensors. The channel of flat index e is (e /
// inner) % C with inner = H * W for NCHW and 1 for channels-last; each
// thread tracks it incrementally along its grid-stride walk, so the walk
// divides only once. The per-channel vectors are read through the
// read-only cache.
//
// Numerics: paired_sums accumulates float32 in another order than
// torch.sum (within 1e-5 of each channel's sum of term magnitudes on the
// card, chip_smoke.py). bn_affine evaluates the plain version's operations
// in its order, each rounded to the compute type as PyTorch rounds a bf16
// tensor op (computed in float32, rounded to nearest even): p * a, then
// + q * b, then + c. Compiled with --fmad=false, its output is bit-equal
// to the plain version given the same vectors.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads of a sums or affine block
constexpr int kBlocksPerSm = 8;   // 2048 threads: a full SM
constexpr int kMinRows = 16;      // rows a thread walks at least (channels-last)
constexpr int64_t kMinChunk = 2048;  // elements of a plane chunk at least (NCHW)

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

// V elements at p as floats: one 16-byte load (kVec), else element by
// element, 0 past `left`.
template <typename R, bool kVec>
__device__ __forceinline__ void load_run(const R* p, float* v, int64_t left) {
  constexpr int V = Elem<R>::kVec;
  if (kVec) {
    Pack<R> pk;
    pk.u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = Elem<R>::to_f(pk.r[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = j < left ? Elem<R>::to_f(Elem<R>::load(p + j)) : 0.0f;
  }
}

// ---- paired sums, level one: channels-last [rows, C]

template <typename R, bool kVec, bool kSame>
__global__ void __launch_bounds__(kThreads)
sums_rows_kernel(const R* __restrict__ a, const R* __restrict__ b,
                 float* __restrict__ partial,  // [gridDim.x, 2, C]
                 int64_t rows, int c, int tx) {
  constexpr int V = Elem<R>::kVec;
  __shared__ float red[2][kThreads * V];
  const int ty = kThreads / tx;
  const int gx = threadIdx.x % tx, gy = threadIdx.x / tx;
  const int c0 = (blockIdx.y * tx + gx) * V;  // this thread's first channel
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.0f;
  if (c0 < c) {
    const int64_t step = static_cast<int64_t>(gridDim.x) * ty;
#pragma unroll 4
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * ty + gy; r < rows; r += step) {
      const int64_t off = r * c + c0;
      float va[V], vb[V];
      load_run<R, kVec>(a + off, va, c - c0);
      if (kSame) {
#pragma unroll
        for (int j = 0; j < V; ++j) vb[j] = va[j];
      } else {
        load_run<R, kVec>(b + off, vb, c - c0);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] += va[j];
        s2[j] += va[j] * vb[j];
      }
    }
  }
  // the block's rows (its y threads) in a fixed tree
  const int width = tx * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[0][gy * width + gx * V + j] = s1[j];
    red[1][gy * width + gx * V + j] = s2[j];
  }
  __syncthreads();
  for (int half = ty / 2; half > 0; half /= 2) {
    if (gy < half) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[0][gy * width + gx * V + j] += red[0][(gy + half) * width + gx * V + j];
        red[1][gy * width + gx * V + j] += red[1][(gy + half) * width + gx * V + j];
      }
    }
    __syncthreads();
  }
  if (gy == 0 && c0 < c) {
    float* out = partial + static_cast<int64_t>(blockIdx.x) * 2 * c;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (c0 + j < c) {
        out[c0 + j] = red[0][gx * V + j];
        out[c + c0 + j] = red[1][gx * V + j];
      }
    }
  }
}

// ---- paired sums, level one: contiguous NCHW [n, C, inner]

// thread 0 gets the block's sum of v, in a fixed order
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) t += scratch[w];
  }
  __syncthreads();
  return t;
}

template <typename R, bool kSame>
__global__ void __launch_bounds__(kThreads)
sums_planes_kernel(const R* __restrict__ a, const R* __restrict__ b,
                   float* __restrict__ partial,  // [gridDim.x, 2, C]
                   int n, int c, int64_t inner, int chunks, int vec) {
  constexpr int V = Elem<R>::kVec;
  __shared__ float scratch[kThreads / 32];
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
    // [body, end): 16-byte loads; [lo, body) and [end, hi): one by one
    int64_t body = lo, end = lo;
    if (vec) {
      const uintptr_t addr = reinterpret_cast<uintptr_t>(pa + lo);
      const int64_t head = static_cast<int64_t>((16 - addr % 16) % 16) / sizeof(R);
      body = lo + head < hi ? lo + head : hi;
      end = body + (hi - body) / V * V;
    }
    for (int64_t i = body + static_cast<int64_t>(threadIdx.x) * V; i < end;
         i += static_cast<int64_t>(kThreads) * V) {
      float va[V], vb[V];
      load_run<R, true>(pa + i, va, V);
      if (kSame) {
#pragma unroll
        for (int j = 0; j < V; ++j) vb[j] = va[j];
      } else {
        load_run<R, true>(pb + i, vb, V);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] += va[j];
        s2[j] += va[j] * vb[j];
      }
    }
    for (int64_t i = lo + threadIdx.x; i < body; i += kThreads) {
      const float va = Elem<R>::to_f(Elem<R>::load(pa + i));
      const float vb = kSame ? va : Elem<R>::to_f(Elem<R>::load(pb + i));
      s1[0] += va;
      s2[0] += va * vb;
    }
    for (int64_t i = end + threadIdx.x; i < hi; i += kThreads) {
      const float va = Elem<R>::to_f(Elem<R>::load(pa + i));
      const float vb = kSame ? va : Elem<R>::to_f(Elem<R>::load(pb + i));
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
  }
}

// ---- paired sums, level two: out[k] = sum over blocks of partial[:, k]

__global__ void __launch_bounds__(1024)
sums_finish_kernel(const float* __restrict__ partial, float* __restrict__ out, int blocks,
                   int width) {
  __shared__ float red[32][33];
  const int lane = threadIdx.x, row = threadIdx.y;  // a block is 32 x 32 threads
  const int k = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (k < width) {
    for (int i = row; i < blocks; i += 32) s += partial[static_cast<int64_t>(i) * width + k];
  }
  red[row][lane] = s;
  __syncthreads();
  for (int half = 16; half > 0; half /= 2) {
    if (row < half) red[row][lane] += red[row + half][lane];
    __syncthreads();
  }
  if (row == 0 && k < width) out[k] = red[0][lane];
}

// ---- the affine: out = ((p * a) [+ (q * b)]) + c, per channel

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
    float fp[V], fq[V];
    if (full) {
      load_run<R, true>(p + e, fp, V);
      if (kQ) load_run<R, true>(q + e, fq, V);
    } else {
      load_run<R, false>(p + e, fp, left);
      if (kQ) load_run<R, false>(q + e, fq, left);
    }
    Pack<R> pk;
    int64_t pj = pos;
    int cj = ch;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float y = Elem<R>::round(fp[j] * Elem<R>::to_f(Elem<R>::load(va + cj)));
      if (kQ) {
        const float t = Elem<R>::round(fq[j] * Elem<R>::to_f(Elem<R>::load(vb + cj)));
        y = Elem<R>::round(y + t);
      }
      pk.r[j] = Elem<R>::from_f(y + Elem<R>::to_f(Elem<R>::load(vc + cj)));
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

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms <= 0)
    return 132;
  return sms;
}

int vec_width(int dtype) { return dtype == 1 ? 8 : 4; }

// The level-one grid of a paired-sums call: its blocks in x (the rows of
// the workspace) and y, and the channel-tile width tx (channels-last) or
// the chunks a plane is cut into (NCHW).
struct SumsGrid {
  dim3 grid;
  int tx = 0;
  int chunks = 0;
};

SumsGrid sums_grid(int layout, int64_t n, int c, int64_t inner, int dtype) {
  SumsGrid g;
  const int64_t target = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  if (layout == 0) {  // channels-last: rows = n * inner
    const int64_t rows = n * inner;
    const int v = vec_width(dtype);
    const int groups = (c + v - 1) / v;
    int tx = 1;
    while (tx < groups && tx < kThreads) tx *= 2;
    const int ty = kThreads / tx;
    const int gy = (groups + tx - 1) / tx;
    int64_t gx = (target + gy - 1) / gy;
    const int64_t most = (rows + static_cast<int64_t>(ty) * kMinRows - 1) /
                         (static_cast<int64_t>(ty) * kMinRows);
    if (gx > most) gx = most;
    if (gx < 1) gx = 1;
    g.grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), 1);
    g.tx = tx;
  } else {  // NCHW: a block per (channel, share of the planes or plane chunks)
    const int64_t want = (target + c - 1) / c;
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
         inner >= 0 && c <= 65535 && n <= 0x7fffffffLL;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename R>
int launch_sums(const void* a_, const void* b_, float* work, float* out, int layout, int64_t n,
                int c, int64_t inner, int dtype, cudaStream_t s) {
  const R* a = static_cast<const R*>(a_);
  const R* b = static_cast<const R*>(b_);
  const bool same = a == b;
  const SumsGrid g = sums_grid(layout, n, c, inner, dtype);
  if (layout == 0) {
    const bool vec = c % Elem<R>::kVec == 0 && aligned16(a) && aligned16(b);
    const int64_t rows = n * inner;
    if (vec && same)
      sums_rows_kernel<R, true, true><<<g.grid, kThreads, 0, s>>>(a, b, work, rows, c, g.tx);
    else if (vec)
      sums_rows_kernel<R, true, false><<<g.grid, kThreads, 0, s>>>(a, b, work, rows, c, g.tx);
    else if (same)
      sums_rows_kernel<R, false, true><<<g.grid, kThreads, 0, s>>>(a, b, work, rows, c, g.tx);
    else
      sums_rows_kernel<R, false, false><<<g.grid, kThreads, 0, s>>>(a, b, work, rows, c, g.tx);
  } else {
    // the same offset from a 16-byte boundary at every index of a and b
    const int vec = (reinterpret_cast<uintptr_t>(a) - reinterpret_cast<uintptr_t>(b)) % 16 == 0;
    if (same)
      sums_planes_kernel<R, true><<<g.grid, kThreads, 0, s>>>(
          a, b, work, static_cast<int>(n), c, inner, g.chunks, vec);
    else
      sums_planes_kernel<R, false><<<g.grid, kThreads, 0, s>>>(
          a, b, work, static_cast<int>(n), c, inner, g.chunks, vec);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int width = 2 * c;
  sums_finish_kernel<<<(width + 31) / 32, dim3(32, 32), 0, s>>>(
      work, out, static_cast<int>(g.grid.x), width);
  return static_cast<int>(cudaGetLastError());
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
  constexpr int V = Elem<R>::kVec;
  const int64_t numel = n * c * hw;
  const int64_t inner = layout == 0 ? 1 : hw;
  const int64_t groups = (numel + V - 1) / V;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  if (blocks > most) blocks = most;
  const int64_t stride = blocks * kThreads * V;
  const int64_t step_pos = stride % inner;
  const int step_ch = static_cast<int>((stride / inner) % c);
  const bool vec = aligned16(p) && aligned16(out) && (q == nullptr || aligned16(q));
  const dim3 grid(static_cast<unsigned>(blocks));
  if (q != nullptr && vec)
    affine_kernel<R, true, true><<<grid, kThreads, 0, s>>>(p, q, va, vb, vc, out, numel, c,
                                                           inner, step_pos, step_ch);
  else if (q != nullptr)
    affine_kernel<R, true, false><<<grid, kThreads, 0, s>>>(p, q, va, vb, vc, out, numel, c,
                                                            inner, step_pos, step_ch);
  else if (vec)
    affine_kernel<R, false, true><<<grid, kThreads, 0, s>>>(p, q, va, vb, vc, out, numel, c,
                                                            inner, step_pos, step_ch);
  else
    affine_kernel<R, false, false><<<grid, kThreads, 0, s>>>(p, q, va, vb, vc, out, numel,
                                                             c, inner, step_pos, step_ch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tensors are [n, C, H, W] with hw = H * W, in one of two dense layouts:
// layout 0 = channels-last memory (NHWC), 1 = contiguous NCHW. dtype 0 =
// float32, 1 = bfloat16. Each launcher returns cudaGetLastError() after
// its launches (0 on success).

// The float32 elements of the workspace a paired-sums call needs.
extern "C" long long mtlx_bn_sums_workspace(int layout, long long n, int c, long long hw,
                                            int dtype) {
  if (!valid_shape(layout, n, c, hw, dtype) || n * hw == 0) return 0;
  return static_cast<long long>(sums_grid(layout, n, c, hw, dtype).grid.x) * 2 * c;
}

// out [2, C] float32 = (sum of a, sum of a * b) per channel; a and b in
// one layout and type; work holds mtlx_bn_sums_workspace floats.
extern "C" int mtlx_bn_paired_sums(const void* a, const void* b, void* work, void* out,
                                   int layout, long long n, int c, long long hw, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_shape(layout, n, c, hw, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (n * hw == 0)
    return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(float) * 2 * c, s));
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_sums<float>(a, b, w, o, layout, n, c, hw, dtype, s);
  return launch_sums<unsigned short>(a, b, w, o, layout, n, c, hw, dtype, s);
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
