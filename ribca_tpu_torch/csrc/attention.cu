// Short-sequence multi-head attention for the ViT blocks, on Hopper.
//
// Replaces the Pallas TPU kernel ribca_tpu/ops/attention.py::fused_attention
// (_attn_kernel). It computes the same function: S = (q * scale) K^T with
// f32 accumulation, keys >= L excluded, an f32 softmax over the keys, P
// rounded to the input type, then O = P V, written in the input type. The
// whole sequence (L <= 128) fits one warp's registers, so there is no online
// softmax. Where the ViT's plain composition (models/vit.py,
// reference_attention) rounds to the input type, so does the kernel: q *
// scale and S before the softmax, then P. The softmax uses expf and the
// correctly rounded quotient e / sum (div_rn below), as PyTorch's does;
// nothing is built with fast math.
//
// q, k, v and o are strided (batch, head, row, dim) views with unit stride
// along dim. The ViT passes the three unbind views of its fused qkv
// projection, (B, L, 3, H, hd) in memory, and an output whose storage is
// (B, L, H, hd), so no copy runs before or after the kernel.
//
// What bounds it on an H100 (SXM, 3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s
// f32 on the CUDA cores): the main path calls it with H = 12, L = 101,
// hd = 24 and B = 4096 cells (the CLI's dispatch), 2048 (a slide's tail) or
// 8192 (pack_cells). It must read q, k, v and write o once:
// 4 * 101 * 24 * 2 B per (cell, head) pair, 1.91 GB at B = 8192, so
// 0.57 / 0.28 / 0.14 ms at the memory rate in bf16 (twice the bytes in
// f32). It does 4 * L^2 * hd = 0.98 MFLOP per pair, 96 GFLOP at B = 8192:
// 0.10 ms on the bf16 tensor cores, so bf16 is bound by bytes, but 1.44 ms
// on the f32 CUDA cores, so f32 is bound by operations.
//
// Design. A block is persistent: it walks over (cell, head) pairs with the
// grid's stride, so the blocks in flight hold the neighbouring heads of a
// few cells and the 48-byte head slices that the fused layout interleaves
// are fetched from device memory once and shared through L2. Each pair's
// q, k and v are staged in shared memory with cp.async, 16 bytes a copy
// where the pointers and strides allow (8, 4 or 2 otherwise), into two
// buffers: the next pair loads while the current one computes. The pad
// rows and columns are zeroed once and never written.
//
// bf16: one warp per 16 query rows (7 warps at L = 101). Both products run
// on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate),
// fed by ldmatrix (.trans for V); hd is padded to a multiple of 16 for
// Q K^T and to a multiple of 8 for P V, the keys to a multiple of 16. S,
// the softmax and P stay in registers: the row max and sum combine the
// four threads of a quad with shuffles, and the C fragments of S become
// the A fragments of P V without a trip through shared memory. Every loop
// has compile-time bounds (templates on the tile counts), so the tiles'
// independent work interleaves. On the card compute alone takes most of
// the full time and staging alone, on the ViT's fused views, more than
// half of it; the two overlap only in part (PERF.md, measured with the
// RIBCA_ATTN_PART builds below).
//
// f32 (parity mode): no tensor cores, f32 stays f32. The CUDA-core loops
// are register-blocked: a warp owns 8 query rows and each lane 4 keys, so
// one 16-byte shared load of k feeds 32 FMAs; P V spreads (4-dim chunk,
// key subset) over all 32 lanes and reduces the key subsets with shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxLen = 128;
constexpr int kMaxHeadDim = 64;
constexpr int kF32Rows = 8;   // query rows per warp in the f32 kernel
constexpr int kF32Warps = 8;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of (batch, head, row) for q, k, v, o
  long long sq[3], sk[3], sv[3], so[3];
  int batch, heads, len, hd, width;
  float scale;
};

// -- shared-memory layout ------------------------------------------------------

// bf16: rows padded to 16, a row of 16 * ceil(hd / 16) + 8 elements, so the
// eight 16-byte rows that one ldmatrix reads fall in distinct banks.
// (the kernel has them as template constants)
inline int bf16_rows(int len) { return (len + 15) / 16 * 16; }
inline int bf16_stride(int hd) { return (hd + 15) / 16 * 16 + 8; }
// f32: rows padded to 8, a row of 4 * odd elements, so the rows of
// neighbouring keys that lanes read as float4 fall in distinct banks.
__host__ __device__ inline int f32_rows(int len) { return (len + 7) / 8 * 8; }
__host__ __device__ inline int f32_stride(int hd) {
  return 4 * (((hd + 3) / 4) | 1);
}
inline int f32_warps(int len) {
  const int groups = (len + kF32Rows - 1) / kF32Rows;
  return groups < kF32Warps ? groups : kF32Warps;
}

// -- small device helpers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(W));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one group of copies is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b for one 16x8x16 tile: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// a and b rounded to bf16 and back, as the plain version's casts do; the
// packed pair is returned for the row max, which bf16 takes exactly
__device__ __forceinline__ __nv_bfloat162 round_bf16x2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
  a = __uint_as_float(u << 16);  // a bf16 is the top half of its float
  b = __uint_as_float(u & 0xffff0000u);
  return h;
}
// 1 / b as hi + lo: hi = RN(1 / b), and lo its error, from the remainder
// 1 - b hi, which an FMA gives exactly.
struct Recip {
  float hi, lo;
};
__device__ __forceinline__ Recip recip(float b) {
  const float hi = __frcp_rn(b);
  return {hi, __fmul_rn(__fmaf_rn(-b, hi, 1.f), hi)};
}

// a / b rounded to nearest, as `a / b` gives it, in four FP32 operations:
// q = a (hi + lo) is within a hair of a / b, and one FMA correction
// q + (a - b q) hi, the remainder exact, makes it the correctly rounded
// quotient (Markstein's theorem, as hi = RN(1 / b)) wherever that is a
// normal number. `a / b` runs the same kind of sequence plus a range check
// that sends a subnormal quotient to a slow path; a softmax term in [0, 1]
// over its row sum in [1, 128] needs that path only for a P below 2^-126,
// where one ulp is far below what bf16 P V can see.
__device__ __forceinline__ float div_rn(float a, float b, Recip r) {
  const float q = __fmaf_rn(a, r.hi, __fmul_rn(a, r.lo));
  return __fmaf_rn(__fmaf_rn(-b, q, a), r.hi, q);
}

// (a, b) bf16 pair times scale, each product rounded to bf16 again
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&x);
  const float2 f = __bfloat1622float2(h);
  return pack_bf16(f.x * scale, f.y * scale);
}

// -- staging one (cell, head) pair -----------------------------------------------

template <int W, typename T>
__device__ __forceinline__ void copy_piece(T* dst, const T* src) {
  if constexpr (W >= 4) {
    cp_async<W>(dst, src);
  } else {
    *dst = *src;
  }
}

// A thread's share of staging a pair: pieces of `elems` elements at
// columns col, col + span, ... of rows first, first + step, ...; fixed for
// the kernel's life. Threads past the last whole row of pieces copy none.
struct Stager {
  int first, step, col, span;
};

__device__ __forceinline__ Stager make_stager(const Args& a, int elem) {
  const int elems = a.width / elem;
  const int per_row = a.hd / elems;
  const int lanes = per_row < (int)blockDim.x ? per_row : (int)blockDim.x;
  Stager st;
  st.step = blockDim.x / lanes;
  st.first = threadIdx.x / lanes;
  st.col = (threadIdx.x - st.first * lanes) * elems;
  st.span = lanes * elems;
  if (st.first >= st.step) st.first = a.len;
  return st;
}

// Copy the `len` rows of `hd` elements of q, k and v of pair (cell, head)
// into the three planes of `buf`, rows `stride` elements apart, in W-byte
// pieces.
template <typename T, int W>
__device__ __forceinline__ void stage_pair_w(const Args& a, const Stager& st,
                                             int cell, int head, T* buf,
                                             int plane, int stride) {
  const T* q = static_cast<const T*>(a.q) + cell * a.sq[0] + head * a.sq[1];
  const T* k = static_cast<const T*>(a.k) + cell * a.sk[0] + head * a.sk[1];
  const T* v = static_cast<const T*>(a.v) + cell * a.sv[0] + head * a.sv[1];
  q += st.col;
  k += st.col;
  v += st.col;
  for (int r = st.first; r < a.len; r += st.step) {
    T* d = buf + r * stride + st.col;
    const long long rq = r * a.sq[2], rk = r * a.sk[2], rv = r * a.sv[2];
    for (int c = 0; c < a.hd - st.col; c += st.span) {
      copy_piece<W>(d + c, q + rq + c);
      copy_piece<W>(d + plane + c, k + rk + c);
      copy_piece<W>(d + 2 * plane + c, v + rv + c);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_pair(const Args& a, const Stager& st,
                                           int cell, int head, T* buf,
                                           int plane, int stride) {
  switch (a.width) {
    case 16: stage_pair_w<T, 16>(a, st, cell, head, buf, plane, stride); break;
    case 8: stage_pair_w<T, 8>(a, st, cell, head, buf, plane, stride); break;
    case 4: stage_pair_w<T, 4>(a, st, cell, head, buf, plane, stride); break;
    default:
      if constexpr (sizeof(T) == 2) {
        stage_pair_w<T, 2>(a, st, cell, head, buf, plane, stride);
      }
  }
}

// RIBCA_ATTN_PART, a build option for timing the two halves of the loop
// below apart (tools/attention_split.py): 1 stages every pair and computes
// none, 2 stages only a block's first two pairs and computes every pair
// from them. The port builds the default, 0: both.
#ifndef RIBCA_ATTN_PART
#define RIBCA_ATTN_PART 0
#endif

// The persistent loop shared by both kernels. Pairs are taken gridDim.x
// apart, as (cell, head), stepped without a division. Two buffers: the
// next pair's copies are in flight while the current pair computes (a
// third buffer measured no faster). `prepare` runs once the current pair
// has landed (and after a barrier); `compute` after a second barrier if
// `prepare` did any work.
template <typename T, typename Prepare, typename Compute>
__device__ __forceinline__ void pair_loop(const Args& a, int rows, int stride,
                                          Prepare prepare, Compute compute) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const bufs = reinterpret_cast<T*>(smem_raw);
  const int plane = rows * stride;
  const Stager st = make_stager(a, sizeof(T));

  // zero both buffers once: the copies never write the pad rows and columns
  uint4* z = reinterpret_cast<uint4*>(smem_raw);
  const int n16 = (int)(6 * (size_t)plane * sizeof(T) / 16);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int step_b = gridDim.x / a.heads;
  const int step_h = gridDim.x - step_b * a.heads;
  auto advance = [&](int& cell, int& head) {
    cell += step_b;
    head += step_h;
    if (head >= a.heads) {
      head -= a.heads;
      ++cell;
    }
  };
  int cell = blockIdx.x / a.heads, head = blockIdx.x - cell * a.heads;
  int load_cell = cell, load_head = head, slot = 0, staged = 0;
  auto stage_next = [&](int into) {
    if (load_cell < a.batch && (RIBCA_ATTN_PART != 2 || staged++ < 2)) {
      stage_pair<T>(a, st, load_cell, load_head, bufs + into * 3 * plane,
                    plane, stride);
    }
    cp_async_commit();
    advance(load_cell, load_head);
  };
  stage_next(0);
  while (cell < a.batch) {
    stage_next(slot ^ 1);
    cp_async_wait_one();
    __syncthreads();
    T* cur = bufs + slot * 3 * plane;
    if constexpr (RIBCA_ATTN_PART != 1) {
      if (prepare(cur)) __syncthreads();
      compute(cur, cell, head);
    }
    __syncthreads();  // `cur` is restaged two pairs on
    advance(cell, head);
    slot ^= 1;
  }
}

// -- bf16: tensor cores ------------------------------------------------------------

// NKP = ceil(len / 16): 16-row query tiles, one per warp, and 16-key steps;
// HD8 = ceil(hd / 8) output tiles of 8 dims; K16 = ceil(hd / 16) k-steps.
// Both are template arguments so that every loop below is straight-line
// code: the scheduler can interleave the tiles' independent work.
template <int NKP, int HD8>
__global__ void __launch_bounds__(32 * NKP) attention_bf16(const Args a) {
  constexpr int K16 = (HD8 + 1) / 2;
  constexpr int NT = 2 * NKP;  // 8-key tiles
  constexpr int kRows = 16 * NKP;
  constexpr int kStride = 16 * K16 + 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // row within the 8-row half of a tile
  const int tig = lane & 3;  // column pair within an 8-column tile
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's query rows

  auto no_prepare = [](__nv_bfloat16*) { return false; };
  auto compute = [&](__nv_bfloat16* buf, int cell, int head) {
    const __nv_bfloat16* q_s = buf;
    const __nv_bfloat16* k_s = buf + kRows * kStride;
    const __nv_bfloat16* v_s = buf + 2 * kRows * kStride;

    // A fragments of q * scale, rounded to bf16 as the plain version does
    uint32_t qa[K16][4];
#pragma unroll
    for (int ks = 0; ks < K16; ++ks) {
      ldsm_x4(qa[ks], q_s + (r0 + (lane & 15)) * kStride + 16 * ks +
                          (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[ks][i] = scale_bf16x2(qa[ks][i], a.scale);
    }

    // S = (q * scale) K^T, 16 keys (two 8-key tiles) at a time
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
#pragma unroll
      for (int ks = 0; ks < K16; ++ks) {
        uint32_t b[4];
        ldsm_x4(b, k_s + (8 * n + (lane & 7) + (lane >> 4) * 8) * kStride +
                       16 * ks + ((lane >> 3) & 1) * 8);
        mma_bf16(s[n], qa[ks], b[0], b[1]);
        mma_bf16(s[n + 1], qa[ks], b[2], b[3]);
      }
    }

    // softmax over the keys in f32 of S rounded to bf16; keys >= len, which
    // only the last 16-key step holds, are -inf. The thread holds rows g
    // (s[n][0..1]) and g + 8 (s[n][2..3]) of its warp's tile. Work on rows
    // past the end (the last warp's upper half, when it holds none) and on
    // the last 8 keys (when all are past the end) is skipped.
    const bool hi_live = r0 + 8 < a.len;
    const bool last_live = 8 * (NT - 1) < a.len;
    __nv_bfloat162 mx0 = __float2bfloat162_rn(-CUDART_INF_F), mx1 = mx0;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= NT - 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (8 * n + 2 * tig + (i & 1) >= a.len) s[n][i] = -CUDART_INF_F;
        }
      }
      mx0 = __hmax2(mx0, round_bf16x2(s[n][0], s[n][1]));
      mx1 = __hmax2(mx1, round_bf16x2(s[n][2], s[n][3]));
    }
    float m0 = fmaxf(__low2float(mx0), __high2float(mx0));
    float m1 = fmaxf(__low2float(mx1), __high2float(mx1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));

    // e = expf(s - m), its row sums, and P = e / sum in bf16 pairs, packed
    // as the A fragments of P V: the C layout of two m16n8 tiles is the A
    // layout of one m16n8k16 step. pl holds rows g, ph rows g + 8.
    uint32_t pl[NT], ph[NT];
    auto softmax_half = [&](int i0, float m, uint32_t (&p)[NT]) {
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < NT - 1 || last_live) {
          s[n][i0] = expf(s[n][i0] - m);
          s[n][i0 + 1] = expf(s[n][i0 + 1] - m);
          sum += s[n][i0] + s[n][i0 + 1];
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const Recip y = recip(sum);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        p[n] = n < NT - 1 || last_live
                   ? pack_bf16(div_rn(s[n][i0], sum, y),
                               div_rn(s[n][i0 + 1], sum, y))
                   : 0u;
      }
    };
    softmax_half(0, m0, pl);
    if (hi_live) {
      softmax_half(2, m1, ph);
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) ph[n] = 0u;
    }

    // O = P V
    float o[HD8][4];
#pragma unroll
    for (int d = 0; d < HD8; ++d) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      const uint32_t pf[4] = {pl[n], ph[n], pl[n + 1], ph[n + 1]};
      const __nv_bfloat16* vrow = v_s + (8 * n + (lane & 15)) * kStride;
#pragma unroll
      for (int d = 0; d + 1 < HD8; d += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, vrow + 8 * d + (lane >> 4) * 8);
        mma_bf16(o[d], pf, b[0], b[1]);
        mma_bf16(o[d + 1], pf, b[2], b[3]);
      }
      if constexpr (HD8 % 2 == 1) {
        uint32_t b[2];
        ldsm_x2_t(b, vrow + 8 * (HD8 - 1));
        mma_bf16(o[HD8 - 1], pf, b[0], b[1]);
      }
    }

    // write O from the f32 accumulators, rounded once
    __nv_bfloat16* out =
        static_cast<__nv_bfloat16*>(a.o) + cell * a.so[0] + head * a.so[1];
    const bool paired = a.width >= 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half;
      if (row < a.len) {
        __nv_bfloat16* orow = out + row * a.so[2];
#pragma unroll
        for (int d = 0; d < HD8; ++d) {
          const int col = 8 * d + 2 * tig;
          const float lo = o[d][2 * half], hi = o[d][2 * half + 1];
          if (paired) {
            if (col < a.hd) {
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(lo, hi);
            }
          } else {
            if (col < a.hd) orow[col] = __float2bfloat16_rn(lo);
            if (col + 1 < a.hd) orow[col + 1] = __float2bfloat16_rn(hi);
          }
        }
      }
    }
  };
  pair_loop<__nv_bfloat16>(a, kRows, kStride, no_prepare, compute);
}

// -- f32: register-blocked CUDA cores ----------------------------------------------

__global__ void __launch_bounds__(kF32Warps * 32) attention_f32(const Args a) {
  const int rows = f32_rows(a.len);
  const int stride = f32_stride(a.hd);
  const int s4 = stride / 4;  // row stride in float4
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int hd4 = (a.hd + 3) / 4;
  // P V: lane = (4-dim chunk c, key subset ks); chunks padded to a power of 2
  int chunks = 1;
  while (chunks < hd4) chunks *= 2;
  const int c = lane % chunks;
  const int ksub = lane / chunks;
  const int nsub = 32 / chunks;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per-warp P, [key][row], after both staging buffers
  float* p_all = reinterpret_cast<float*>(smem_raw) + 6 * rows * stride;
  float4* p_s = reinterpret_cast<float4*>(p_all + warp * kMaxLen * kF32Rows);

  // q * scale in place, once per pair
  auto prepare = [&](float* buf) {
    for (int i = threadIdx.x; i < a.len * a.hd; i += blockDim.x) {
      const int r = i / a.hd;
      float& x = buf[r * stride + (i - r * a.hd)];
      x = x * a.scale;
    }
    return true;
  };
  auto compute = [&](float* buf, int cell, int head) {
    const float4* q_s = reinterpret_cast<const float4*>(buf);
    const float4* k_s = reinterpret_cast<const float4*>(buf + rows * stride);
    const float4* v_s = reinterpret_cast<const float4*>(buf + 2 * rows * stride);
    float* out = static_cast<float*>(a.o) + cell * a.so[0] + head * a.so[1];

    for (int r0 = warp * kF32Rows; r0 < a.len; r0 += nwarps * kF32Rows) {
      // S: lane owns keys lane + 32 t; lanes past the end read the last key
      int key[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        key[t] = lane + 32 * t < a.len ? lane + 32 * t : a.len - 1;
      }
      float acc[kF32Rows][4];
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[r][t] = 0.f;
      }
      for (int d = 0; d < hd4; ++d) {
        float4 kv[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          kv[t] = 32 * t < a.len ? k_s[key[t] * s4 + d]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          const float4 qv = q_s[(r0 + r) * s4 + d];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            acc[r][t] = fmaf(qv.x, kv[t].x, acc[r][t]);
            acc[r][t] = fmaf(qv.y, kv[t].y, acc[r][t]);
            acc[r][t] = fmaf(qv.z, kv[t].z, acc[r][t]);
            acc[r][t] = fmaf(qv.w, kv[t].w, acc[r][t]);
          }
        }
      }
      // softmax of each row over the lanes' keys
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        float m = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (lane + 32 * t >= a.len) acc[r][t] = -CUDART_INF_F;
          m = fmaxf(m, acc[r][t]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        }
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[r][t] = lane + 32 * t < a.len ? expf(acc[r][t] - m) : 0.f;
          sum += acc[r][t];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[r][t] = acc[r][t] / sum;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = lane + 32 * t;
        if (j < a.len) {
          p_s[2 * j] = make_float4(acc[0][t], acc[1][t], acc[2][t], acc[3][t]);
          p_s[2 * j + 1] =
              make_float4(acc[4][t], acc[5][t], acc[6][t], acc[7][t]);
        }
      }
      __syncwarp();

      // O = P V: this lane's chunk of 4 dims over keys ksub, ksub + nsub, ...
      float4 o[kF32Rows];
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) o[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < hd4) {
        for (int j = ksub; j < a.len; j += nsub) {
          const float4 p0 = p_s[2 * j];
          const float4 p1 = p_s[2 * j + 1];
          const float4 vv = v_s[j * s4 + c];
          const float p[kF32Rows] = {p0.x, p0.y, p0.z, p0.w,
                                     p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int r = 0; r < kF32Rows; ++r) {
            o[r].x = fmaf(p[r], vv.x, o[r].x);
            o[r].y = fmaf(p[r], vv.y, o[r].y);
            o[r].z = fmaf(p[r], vv.z, o[r].z);
            o[r].w = fmaf(p[r], vv.w, o[r].w);
          }
        }
      }
      for (int off = chunks; off < 32; off *= 2) {
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          o[r].x += __shfl_xor_sync(0xffffffffu, o[r].x, off);
          o[r].y += __shfl_xor_sync(0xffffffffu, o[r].y, off);
          o[r].z += __shfl_xor_sync(0xffffffffu, o[r].z, off);
          o[r].w += __shfl_xor_sync(0xffffffffu, o[r].w, off);
        }
      }
      if (ksub == 0 && c < hd4) {
        const int col = 4 * c;
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          if (r0 + r < a.len) {
            float* orow = out + (r0 + r) * a.so[2] + col;
            if (a.width == 16) {
              *reinterpret_cast<float4*>(orow) = o[r];
            } else {
              const float vals[4] = {o[r].x, o[r].y, o[r].z, o[r].w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if (col + i < a.hd) orow[i] = vals[i];
              }
            }
          }
        }
      }
      __syncwarp();  // p_s is rewritten for the next rows
    }
  };
  pair_loop<float>(a, rows, stride, prepare, compute);
}

// -- launch ------------------------------------------------------------------------

bool aligned(const void* p, int width) {
  return reinterpret_cast<uintptr_t>(p) % width == 0;
}

// the copy width must divide every pointer, every stride in bytes and a
// row of hd elements; wider than an element, at most 16 bytes
bool width_fits(const Args& a, int elem) {
  const int w = a.width;
  if (!(w == 2 || w == 4 || w == 8 || w == 16) || w < elem) return false;
  if (!(aligned(a.q, w) && aligned(a.k, w) && aligned(a.v, w) &&
        aligned(a.o, w))) {
    return false;
  }
  const long long* strides[4] = {a.sq, a.sk, a.sv, a.so};
  for (const long long* s : strides) {
    for (int i = 0; i < 3; ++i) {
      if ((s[i] * elem) % w != 0) return false;
    }
  }
  return (a.hd * elem) % w == 0;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long pairs = (long long)a.batch * a.heads;
  const long long resident = (long long)sms * per_sm;
  const int blocks = (int)(pairs < resident ? pairs : resident);
  kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

using BF16Kernel = void (*)(Args);

template <int NKP>
BF16Kernel bf16_kernel(int hd8) {
  switch (hd8) {
    case 1: return attention_bf16<NKP, 1>;
    case 2: return attention_bf16<NKP, 2>;
    case 3: return attention_bf16<NKP, 3>;
    case 4: return attention_bf16<NKP, 4>;
    case 5: return attention_bf16<NKP, 5>;
    case 6: return attention_bf16<NKP, 6>;
    case 7: return attention_bf16<NKP, 7>;
    default: return attention_bf16<NKP, 8>;
  }
}

cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const int nkp = (a.len + 15) / 16, hd8 = (a.hd + 7) / 8;
  const size_t smem =
      6 * (size_t)bf16_rows(a.len) * bf16_stride(a.hd) * sizeof(__nv_bfloat16);
  BF16Kernel kernel;
  switch (nkp) {
    case 1: kernel = bf16_kernel<1>(hd8); break;
    case 2: kernel = bf16_kernel<2>(hd8); break;
    case 3: kernel = bf16_kernel<3>(hd8); break;
    case 4: kernel = bf16_kernel<4>(hd8); break;
    case 5: kernel = bf16_kernel<5>(hd8); break;
    case 6: kernel = bf16_kernel<6>(hd8); break;
    case 7: kernel = bf16_kernel<7>(hd8); break;
    default: kernel = bf16_kernel<8>(hd8); break;
  }
  return launch(kernel, a, 32 * nkp, smem, stream);
}

size_t f32_smem(int len, int hd, int warps) {
  return (6 * (size_t)f32_rows(len) * f32_stride(hd) +
          (size_t)warps * kMaxLen * kF32Rows) * sizeof(float);
}

cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  // fewer warps, each with its own P, where both buffers of a long, wide
  // pair leave no room for eight (L = 128, hd = 64 takes five)
  int warps = f32_warps(a.len);
  while (warps > 1 && f32_smem(a.len, a.hd, warps) > (size_t)limit) --warps;
  return launch(attention_f32, a, 32 * warps, f32_smem(a.len, a.hd, warps),
                stream);
}

}  // namespace

extern "C" {

// q, k, v, o: (batch, heads, len, hd) device arrays of one type with unit
// stride along hd; `strides` holds the element strides of (batch, head,
// row) for q, k, v and o in that order (12 values). `width` is the copy
// width in bytes (2, 4, 8 or 16) that every pointer and stride allows.
// dtype 0 = float32, 1 = bfloat16. Launches on `stream` and returns the
// launch's error code without synchronising; cudaErrorInvalidValue for
// arguments the kernel does not take.
cudaError_t ribca_attention(const void* q, const void* k, const void* v,
                            void* o, int batch, int heads, int len, int hd,
                            const long long* strides, int width, float scale,
                            int dtype, void* stream) {
  if (batch < 1 || heads < 1 || len < 1 || len > kMaxLen || hd < 1 ||
      hd > kMaxHeadDim) {
    return cudaErrorInvalidValue;
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  a.batch = batch;
  a.heads = heads;
  a.len = len;
  a.hd = hd;
  a.width = width;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (!width_fits(a, 4)) return cudaErrorInvalidValue;
      return launch_f32(a, s);
    case 1:
      if (!width_fits(a, 2)) return cudaErrorInvalidValue;
      return launch_bf16(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* ribca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
