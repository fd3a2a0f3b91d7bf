// The ROI crop (TF crop_and_resize contract), gather-bilinear: forward
// (kernel B) and the d(image) backward (kernel D), a gather too.
//
// Forward. Replaces the TPU kernel mtlx/kernels/roi_pallas.py _crop_fwd
// (kernel body _fwd_kernel), reached through crop_and_resize_fused.
//
// What bounds it on Hopper: bytes. Each output element is 4 taps and
// ~9 flops; the crop [B, N, ch, cw, C] written once (120 MB in bf16 at
// 300 boxes x 14 x 14 x 1024, 411 MB at 16 x 64 boxes) dwarfs the map
// read (a stride-16 map of 40 x 64 x 1024 is 5 MB and stays in the 50 MB
// L2). A thread per output element (or per 16-byte run of them) reads
// four taps from L2 for each one written and spends its instructions on
// unpacking its index and on its sample coordinates, which 128 threads
// (C / 8) of one sample point all compute alike.
//
// What the design does about it: the TPU kernel built dense [ch, H] and
// [cw, W] interpolation matrices so the crop ran on the matrix unit; here
// that would read H + W weights per output to use four. Here a block
// takes one box (grid x; one 32-bit division finds its image) and a slab
// of its (sample column, 16-byte channel run) pairs. It first tables its
// box's sample rows (sample_axis, the backward's bits) in shared memory;
// each thread computes its own column's taps once, then walks the ch
// sample rows in order and keeps in f32 registers the x-blended values
// (tl + (tr - tl) * fx) of the two source rows it read last. A sample
// row whose lo or hi source row is one of them reads it no more: a box
// that spans fewer source rows than twice its sample rows (nearly every
// proposal on a stride-16 map) costs at most about two 16-byte taps an
// output, not four, and a box shorter than its sample rows under one. An out-of-range sample writes zeros and reads nothing. Taps and
// results move as 16-byte vectors along C (8 bf16 or 4 f32 channels), so
// neighbouring threads read and write neighbouring addresses; the results
// with streaming stores, so the crop does not push the map out of L2.
// Blocks of one box, and the boxes of one image, are neighbours in the
// grid, so an image's map is in L2 while it is cropped (84 MB of training
// maps do not fit at once).
//
// What bounds it now (chip_smoke.py on an H100, PERF.md): not the tap
// bytes. On the main path's proposals it reads under half the taps an
// output that chip_smoke.py's random boxes need, yet saves a fifth of the
// time or less, measured against a fill of the same output. What is left
// is each thread's chain of dependent L2 reads along its sample rows.
//
// Numerics: coordinates follow mtlx.ops.roi._sample_coords in its
// operation order; the taps are interpolated in f32 in the order of
// mtlx.ops.roi.crop_and_resize (top, bottom, then between them) and
// rounded once to the feature type. The x-blend of a source row is the
// same sum whichever sample row needs it, so a cached blend has the bits
// of a fresh one. A sample outside [0, limit - 1] on either axis reads 0
// (extrapolation_value 0). Compiled with --fmad=false, the crop is
// bit-identical to the plain PyTorch version in f32 and in bf16.
//
// Backward. Replaces the TPU kernel mtlx/kernels/roi_pallas.py
// _crop_bwd_image (kernel body _bwd_kernel), the d(image) half of the
// custom VJP _crop_core; the boxes get no gradient, as there.
//
// What bounds it on Hopper: bytes. The gradient dout [B, N, ch, cw, C] is
// read (411 MB in bf16 at 16 x 64 boxes x 14 x 14 x 1024 on the training
// path) and d(image) [B, H, W, C] written once (84 MB in bf16). A scatter
// (one thread per sample point, four atomic adds per element read) pays
// for those bytes four times over in L2 atomics, needs a zeroed float32
// scratch map and a second pass to round it, and sums in no fixed order.
//
// What the design does about it: a gather. The TPU kernel carried d(image)
// in VMEM across a sequential grid over the boxes; here every pixel of
// d(image) is owned by one warp, which finds the samples that touch it.
// The sample coordinates of a box are separable, so a block first puts,
// for each box of its image and each of the ch + cw sample positions, the
// lo tap and the fraction (from sample_axis itself: the forward's bits)
// and each box's row and column extent into shared memory. A warp then
// takes one pixel: its lanes test 32 boxes' extents at once (one ballot),
// and for a box that reaches the pixel they test the ch rows and the cw
// columns of samples at once (two ballots), so the matching (i, j) come
// out in ascending order with no search. For each match the warp reads
// dout[b, n, i, j, :] in 16-byte vectors (each lane four runs of 8 bf16 or
// 4 f32 channels, 512 contiguous bytes a warp and load) and adds
// g * (wy * wx) into float32 registers. The pixel is written once, rounded
// once to the gradient's type. No atomics, no memset, no scratch map, no
// second pass; blocks of one image are neighbours in the grid so its dout
// (25.7 MB) is re-read from L2 (a sample feeds up to 2 x 2 pixels).
//
// Numerics: the same sample coordinates, in-range rule and clamped hi
// tap as the forward (a clamped tap has weight 0 and is skipped); each
// tap's weight is (1 - fy or fy) * (1 - fx or fx) and its term g * weight,
// in f32. A pixel's terms are added box by box in index order, and within
// a box by sample row, then sample column, so two runs give the same
// bits. The plain version adds the same terms in another order
// (index_add_ tap by tap), so the two agree to float32 rounding of the
// sum (chip_smoke.py holds it to 1e-4 of the sum of the terms'
// magnitudes).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
struct Vec;  // 16 bytes of T

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out, int width, bool vec) {
    if (vec) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else {
      for (int j = 0; j < kN; ++j) out[j] = j < width ? p[j] : 0.0f;
    }
  }
  __device__ static void store(float* p, const float* v, int width, bool vec) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; j < width; ++j) p[j] = v[j];
    }
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out, int width, bool vec) {
    if (vec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
      for (int j = 0; j < kN; ++j) out[j] = __bfloat162float(h[j]);
    } else {
      for (int j = 0; j < kN; ++j) out[j] = j < width ? __bfloat162float(p[j]) : 0.0f;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v, int width, bool vec) {
    if (vec) {
      uint4 raw;
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
      for (int j = 0; j < kN; ++j) h[j] = __float2bfloat16_rn(v[j]);
      *reinterpret_cast<uint4*>(p) = raw;
    } else {
      for (int j = 0; j < width; ++j) p[j] = __float2bfloat16_rn(v[j]);
    }
  }
};

// Vec<T>::store with a streaming (evict-first) 16-byte store: the crop
// streams through L2 once, and the map its taps come from stays there.
template <typename T>
__device__ __forceinline__ void store_streaming(T* p, const float* v, int width, bool vec) {
  if (!vec) {
    Vec<T>::store(p, v, width, vec);
  } else if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    uint4 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
    for (int j = 0; j < Vec<T>::kN; ++j) h[j] = __float2bfloat16_rn(v[j]);
    __stcs(reinterpret_cast<uint4*>(p), raw);
  }
}

// One axis of mtlx.ops.roi._sample_coords + crop_and_resize.sample_axis.
struct Axis {
  int lo, hi;
  float frac;
  bool in_range;
};

__device__ __forceinline__ Axis sample_axis(float c0, float c1, int size,
                                            int i, int limit) {
  const float lim1 = static_cast<float>(limit - 1);
  float coord;
  if (size > 1) {
    const float step = (c1 - c0) * lim1 / static_cast<float>(size - 1);
    coord = c0 * lim1 + step * static_cast<float>(i);
  } else {
    coord = 0.5f * (c0 + c1) * lim1;
  }
  const float lo = floorf(coord);
  Axis a;
  a.frac = coord - lo;
  int lo_i = static_cast<int>(lo);
  lo_i = lo_i < 0 ? 0 : (lo_i > limit - 1 ? limit - 1 : lo_i);
  const int hi_i = lo_i + 1 > limit - 1 ? limit - 1 : lo_i + 1;
  a.lo = lo_i;
  a.hi = hi_i;
  a.in_range = coord >= 0.0f && coord <= lim1;
  return a;
}

// One sample position of a box on one axis: the lo tap (-1 when the
// sample is out of range) and the fraction towards the hi tap.
struct Tap {
  int lo;
  float frac;
};

constexpr int kFwdThreads = 128;  // threads of a block
constexpr int kFwdRowChunk = 64;  // sample rows tabled in shared memory at once

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
roi_crop_fwd_kernel(const T* __restrict__ image,      // [B, H, W, C]
                    const float* __restrict__ boxes,  // [B, N, 4]
                    T* __restrict__ out,              // [B, N, ch, cw, C]
                    int num_boxes, int h, int w, int c, int ch, int cw,
                    int chunks, int slabs) {
  constexpr int kV = Vec<T>::kN;
  __shared__ Tap ytab[kFwdRowChunk];
  // the blocks of one box are neighbours, and the boxes of one image: an
  // image's map stays in L2 while its boxes are cropped
  const int bn = blockIdx.x / slabs;  // b * num_boxes + n
  const int slab = blockIdx.x - bn * slabs;
  const int b = bn / num_boxes;
  const float* box = boxes + static_cast<int64_t>(bn) * 4;
  // the thread's sample column x and its run of channels
  const int pair = slab * kFwdThreads + threadIdx.x;
  const bool active = pair < cw * chunks;
  const int x = active ? pair / chunks : 0;
  const int c0 = (pair - x * chunks) * kV;
  const int width = c - c0 < kV ? c - c0 : kV;
  const bool vec = (c % kV) == 0;  // every row start is 16-byte aligned
  const Axis ax = sample_axis(box[1], box[3], cw, x, w);
  const int64_t row_stride = static_cast<int64_t>(w) * c;
  const T* img = image + static_cast<int64_t>(b) * h * row_stride + c0;
  const T* col_lo = img + static_cast<int64_t>(ax.lo) * c;
  const T* col_hi = img + static_cast<int64_t>(ax.hi) * c;
  T* dst = out + (static_cast<int64_t>(bn) * ch * cw + x) * c + c0;
  const int64_t out_row = static_cast<int64_t>(cw) * c;

  // the x-blends of the two source rows read last (-1: none)
  int row_a = -1, row_b = -1;
  float va[kV], vb[kV];
  // the x-blend of source row r: from the two cached rows, else two taps
  auto blend = [&](int r, float* v) {
    if (r == row_a) {
#pragma unroll
      for (int j = 0; j < kV; ++j) v[j] = va[j];
    } else if (r == row_b) {
#pragma unroll
      for (int j = 0; j < kV; ++j) v[j] = vb[j];
    } else {
      float tl[kV], tr[kV];
      Vec<T>::load(col_lo + r * row_stride, tl, width, vec);
      Vec<T>::load(col_hi + r * row_stride, tr, width, vec);
#pragma unroll
      for (int j = 0; j < kV; ++j) v[j] = tl[j] + (tr[j] - tl[j]) * ax.frac;
    }
  };

  for (int r0 = 0; r0 < ch; r0 += kFwdRowChunk) {
    const int rows = min(kFwdRowChunk, ch - r0);
    __syncthreads();  // the last chunk's readers are done
    if (threadIdx.x < rows) {
      const Axis a = sample_axis(box[0], box[2], ch, r0 + threadIdx.x, h);
      ytab[threadIdx.x] = Tap{a.in_range ? a.lo : -1, a.frac};
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < rows; ++i) {
      const Tap ty = ytab[i];
      float res[kV];
      if (ty.lo < 0 || !ax.in_range) {
#pragma unroll
        for (int j = 0; j < kV; ++j) res[j] = 0.0f;
      } else {
        const int hi = ty.lo + 1 > h - 1 ? h - 1 : ty.lo + 1;
        float top[kV], bottom[kV];
        blend(ty.lo, top);
        if (hi == ty.lo) {
#pragma unroll
          for (int j = 0; j < kV; ++j) bottom[j] = top[j];
        } else {
          blend(hi, bottom);
        }
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          res[j] = top[j] + (bottom[j] - top[j]) * ty.frac;
          va[j] = top[j];
          vb[j] = bottom[j];
        }
        row_a = ty.lo;
        row_b = hi;
      }
      store_streaming<T>(dst + (r0 + i) * out_row, res, width, vec);
    }
  }
}

template <typename T>
int launch(const void* image, const void* boxes, void* out, int b, int h,
           int w, int c, int n, int ch, int cw, cudaStream_t stream) {
  constexpr int kV = Vec<T>::kN;
  if (b == 0 || n == 0 || ch == 0 || cw == 0 || c == 0) return 0;
  const int chunks = (c + kV - 1) / kV;
  const int64_t slabs = (static_cast<int64_t>(cw) * chunks + kFwdThreads - 1) / kFwdThreads;
  const int64_t blocks = static_cast<int64_t>(b) * n * slabs;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  roi_crop_fwd_kernel<T><<<static_cast<unsigned int>(blocks), kFwdThreads, 0, stream>>>(
      static_cast<const T*>(image), static_cast<const float*>(boxes),
      static_cast<T*>(out), n, h, w, c, ch, cw, chunks, static_cast<int>(slabs));
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBwdWarps = 8;    // warps of a block, one pixel each per round
constexpr int kBwdRounds = 4;   // pixels a warp takes, one after another
constexpr int kBwdRuns = 4;     // 16-byte runs of channels per lane
constexpr int kBwdTableBytes = 40 * 1024;  // sample tables of one batch of boxes

// The weight with which a sample position feeds pixel coordinate p of its
// axis: 1 - frac on its lo tap, frac on its hi tap (lo + 1; a hi tap
// clamped onto lo has frac 0), 0 when it has no tap there.
__device__ __forceinline__ float tap_weight(const Tap t, int p) {
  if (t.lo < 0) return 0.0f;
  if (t.lo == p) return 1.0f - t.frac;
  return t.lo + 1 == p ? t.frac : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
roi_crop_bwd_kernel(const T* __restrict__ dout,       // [B, N, ch, cw, C]
                    const float* __restrict__ boxes,  // [B, N, 4]
                    T* __restrict__ dimg,             // [B, H, W, C]
                    int num_boxes, int h, int w, int c, int ch, int cw,
                    int box_batch, int pixel_blocks, int slabs) {
  constexpr int kV = Vec<T>::kN;
  extern __shared__ __align__(8) unsigned char smem_raw[];
  Tap* ytab = reinterpret_cast<Tap*>(smem_raw);   // [box_batch][ch]
  Tap* xtab = ytab + box_batch * ch;               // [box_batch][cw]
  int* extent = reinterpret_cast<int*>(xtab + box_batch * cw);  // [box_batch][4]

  // neighbouring blocks share an image (and a slab of channels)
  const int pixel_block = blockIdx.x % pixel_blocks;
  const int slab = (blockIdx.x / pixel_blocks) % slabs;
  const int b = blockIdx.x / (pixel_blocks * slabs);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool vec = (c % kV) == 0;  // every row start is 16-byte aligned
  int c0[kBwdRuns], width[kBwdRuns];
#pragma unroll
  for (int k = 0; k < kBwdRuns; ++k) {
    c0[k] = ((slab * kBwdRuns + k) * 32 + lane) * kV;
    width[k] = c - c0[k] < kV ? c - c0[k] : kV;  // <= 0: no such run
  }
  const float* img_boxes = boxes + static_cast<int64_t>(b) * num_boxes * 4;
  const bool one_batch = num_boxes <= box_batch;

  for (int round = 0; round < kBwdRounds; ++round) {
    const int pixel = (pixel_block * kBwdRounds + round) * kBwdWarps + warp;
    const bool has_pixel = pixel < h * w;
    const int py = pixel / w;
    const int px = pixel - py * w;
    float acc[kBwdRuns][kV];
#pragma unroll
    for (int k = 0; k < kBwdRuns; ++k)
#pragma unroll
      for (int j = 0; j < kV; ++j) acc[k][j] = 0.0f;

    for (int batch0 = 0; batch0 < num_boxes; batch0 += box_batch) {
      const int nb = min(box_batch, num_boxes - batch0);
      if (round == 0 || !one_batch) {
        __syncthreads();  // the last batch's readers are done
        for (int e = tid; e < nb * (ch + cw); e += blockDim.x) {
          const int n = e / (ch + cw);
          const int k = e - n * (ch + cw);
          const float* box = img_boxes + static_cast<int64_t>(batch0 + n) * 4;
          const Axis a = k < ch ? sample_axis(box[0], box[2], ch, k, h)
                                : sample_axis(box[1], box[3], cw, k - ch, w);
          Tap t;
          t.lo = a.in_range ? a.lo : -1;
          t.frac = a.frac;
          if (k < ch) ytab[n * ch + k] = t; else xtab[n * cw + (k - ch)] = t;
        }
        __syncthreads();
        for (int n = tid; n < nb; n += blockDim.x) {
          int y0 = h, y1 = -1, x0 = w, x1 = -1;
          for (int i = 0; i < ch; ++i) {
            const int lo = ytab[n * ch + i].lo;
            if (lo >= 0) { y0 = min(y0, lo); y1 = max(y1, lo + 1); }
          }
          for (int j = 0; j < cw; ++j) {
            const int lo = xtab[n * cw + j].lo;
            if (lo >= 0) { x0 = min(x0, lo); x1 = max(x1, lo + 1); }
          }
          extent[4 * n] = y0; extent[4 * n + 1] = y1;
          extent[4 * n + 2] = x0; extent[4 * n + 3] = x1;
        }
        __syncthreads();
      }
      if (!has_pixel) continue;  // the whole warp
      for (int n0 = 0; n0 < nb; n0 += 32) {
        const int cand = n0 + lane;
        const bool reach = cand < nb && py >= extent[4 * cand] && py <= extent[4 * cand + 1] &&
                           px >= extent[4 * cand + 2] && px <= extent[4 * cand + 3];
        unsigned int box_bits = __ballot_sync(0xffffffffu, reach);
        while (box_bits) {
          const int n = n0 + __ffs(box_bits) - 1;
          box_bits &= box_bits - 1;
          const Tap* yt = ytab + n * ch;
          const Tap* xt = xtab + n * cw;
          // the first 32 sample columns, once per box
          const float wx_first = lane < cw ? tap_weight(xt[lane], px) : 0.0f;
          const unsigned int x_first = __ballot_sync(0xffffffffu, wx_first != 0.0f);
          if (cw <= 32 && !x_first) continue;
          const T* crop = dout + (static_cast<int64_t>(b) * num_boxes + batch0 + n) * ch * cw * c;
          for (int i0 = 0; i0 < ch; i0 += 32) {
            const float wy = i0 + lane < ch ? tap_weight(yt[i0 + lane], py) : 0.0f;
            unsigned int y_bits = __ballot_sync(0xffffffffu, wy != 0.0f);
            while (y_bits) {
              const int li = __ffs(y_bits) - 1;
              y_bits &= y_bits - 1;
              const float wy_i = __shfl_sync(0xffffffffu, wy, li);
              const T* row = crop + static_cast<int64_t>(i0 + li) * cw * c;
              for (int j0 = 0; j0 < cw; j0 += 32) {
                float wx = wx_first;
                unsigned int x_bits = x_first;
                if (j0 > 0) {
                  wx = j0 + lane < cw ? tap_weight(xt[j0 + lane], px) : 0.0f;
                  x_bits = __ballot_sync(0xffffffffu, wx != 0.0f);
                }
                while (x_bits) {
                  const int lj = __ffs(x_bits) - 1;
                  x_bits &= x_bits - 1;
                  const float wgt = wy_i * __shfl_sync(0xffffffffu, wx, lj);
                  if (wgt == 0.0f) continue;
                  const T* src = row + static_cast<int64_t>(j0 + lj) * c;
                  float g[kBwdRuns][kV];
#pragma unroll
                  for (int k = 0; k < kBwdRuns; ++k)
                    if (width[k] > 0) Vec<T>::load(src + c0[k], g[k], width[k], vec);
#pragma unroll
                  for (int k = 0; k < kBwdRuns; ++k)
                    if (width[k] > 0) {
#pragma unroll
                      for (int j = 0; j < kV; ++j) acc[k][j] += g[k][j] * wgt;
                    }
                }
              }
            }
          }
        }
      }
    }
    if (has_pixel) {
      T* dst = dimg + (static_cast<int64_t>(b) * h * w + pixel) * c;
#pragma unroll
      for (int k = 0; k < kBwdRuns; ++k)
        if (width[k] > 0) Vec<T>::store(dst + c0[k], acc[k], width[k], vec);
    }
  }
}

template <typename T>
int launch_bwd(const void* dout, const void* boxes, void* dimg, int b, int h,
               int w, int c, int n, int ch, int cw, cudaStream_t stream) {
  constexpr int kV = Vec<T>::kN;
  const int chunks = (c + kV - 1) / kV;
  const int slabs = (chunks + 32 * kBwdRuns - 1) / (32 * kBwdRuns);
  const int pixel_blocks = (h * w + kBwdWarps * kBwdRounds - 1) / (kBwdWarps * kBwdRounds);
  const int64_t blocks = static_cast<int64_t>(b) * slabs * pixel_blocks;
  if (blocks == 0) return 0;
  const size_t per_box = static_cast<size_t>(ch + cw) * sizeof(Tap) + 4 * sizeof(int);
  int box_batch = static_cast<int>(kBwdTableBytes / per_box);
  if (box_batch < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (box_batch > n) box_batch = n < 1 ? 1 : n;
  roi_crop_bwd_kernel<T><<<static_cast<unsigned int>(blocks), kBwdWarps * 32,
                           box_batch * per_box, stream>>>(
      static_cast<const T*>(dout), static_cast<const float*>(boxes), static_cast<T*>(dimg),
      n, h, w, c, ch, cw, box_batch, pixel_blocks, slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The image and output base pointers
// must be 16-byte aligned (the wrapper checks). Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int mtlx_roi_crop_fwd(const void* image, const void* boxes,
                                 void* out, int b, int h, int w, int c, int n,
                                 int ch, int cw, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(image, boxes, out, b, h, w, c, n, ch, cw, s);
  if (dtype == 1) return launch<__nv_bfloat16>(image, boxes, out, b, h, w, c, n, ch, cw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16 (of dout and of d(image)). Every
// element of out is written, so it needs no zeroing. The base pointers
// must be 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mtlx_roi_crop_bwd(const void* dout, const void* boxes, void* out,
                                 int b, int h, int w, int c, int n, int ch,
                                 int cw, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(dout, boxes, out, b, h, w, c, n, ch, cw, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(dout, boxes, out, b, h, w, c, n, ch, cw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mtlx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
