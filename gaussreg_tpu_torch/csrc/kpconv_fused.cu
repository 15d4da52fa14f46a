// Fused KPConv aggregation (K2):
//   out[r, d] = sum_{k, c} bf16( sum_h infl[r, h, k] * nf[r, h, c] ) * W[k, c, d]
//
// Replaces the Pallas TPU kernel gaussreg_tpu/ops/kpconv_kernel.py:
// _fused_apply_impl (_kernel), with its rounding points: bf16 x bf16
// products (exact in f32) summed over the neighbour slots h in f32, the sum
// rounded to bf16, then contracted with the bf16 weights in f32. Only the
// order of the f32 summations differs. Unlike the TPU kernel (C % 64 == 0,
// C <= 256) it takes every width of the backbone: C a multiple of 4 (the
// wrapper pads other widths to 8), D a multiple of 8, K <= 16.
//
// Bound on the card, on paper: bytes. nf (R x H x C bf16) and infl (R x H x
// K bf16) must be read once; the products are ~46 operations per byte, far
// under the ~295 at which the bf16 tensor cores, not the memory, would
// bound it.
// At the backbone's shapes the 14 calls of a pair move ~1.3 GB (~0.38 ms at
// 3.35 TB/s).
//
// Design (mma.sync m16n8k16 bf16 tensor-core tiles, cp.async copies):
//   - a block owns 64 rows and a 32/64/128-column slice of D, so W is
//     read from L2 once per 64 rows (blocks of one row range run next to
//     each other and share nf and infl in L2);
//   - the block's influences (64 x H x K, a contiguous span) are copied in
//     once by 16-byte cp.async and stay in shared memory;
//   - the channels go in chunks of 16. For each chunk the block streams
//     16-row pieces of nf (16 x H x 16 bf16, 32 bytes per neighbour slot)
//     through a 4-deep cp.async ring, so three pieces (~50 KB) are in
//     flight while one is reduced, and W's (K*16) x D_tile slice of the
//     chunk is fetched with the chunk's first piece;
//   - stage 1: each warp takes two rows of the piece: weighted^T (K x 16) =
//     infl_r^T (K x H) . nf_r (H x 16) on the tensor cores, H in steps of
//     16 (the influences are masked to zero past H and past K), rounded
//     to bf16 in registers and stored as bf16 pairs straight into the
//     (64, K*16) stage-2 tile (no float round trip). The influence
//     fragments are gathered from shared memory in the first chunk and
//     kept in registers (96 per thread) for the others;
//   - stage 2: once a chunk's 64 rows are reduced, out[64, D_tile] +=
//     weighted[64, K*16] . W[K*16, D_tile] with f32 accumulators held in
//     registers across all chunks (8 warps as 2 x 4, 32 rows x D_tile/4
//     columns each); A and B come by ldmatrix from XOR-swizzled tiles;
//   - where the row blocks leave SMs idle (few rows, wide D), the launcher
//     halves the D tile once if the doubled grid still fits in one wave:
//     each further D tile repeats stage 1, but twice the SMs work.
// Stage-1 padding: H is walked in steps of 16 (35 -> 48 at level 0); the
// padded MMA depth is tensor-core time. Shared memory bounds H: H <= 44
// for every K <= 16.
// What bounds a call (tools/kpconv_variants.py on the H100): dropping
// stage 2, or doing it twice, moves a pair by under a fifth, and dropping
// stage 1's products by about a fifth; the rest is the copy pipeline's
// waits and barriers. So mma.sync, not wgmma: faster stage-2 products
// could win at most that fifth.
//
// The KPCONV_* macros below are switches of the timing study
// gaussreg_tpu_torch/tools/kpconv_variants.py (which builds this file with
// -D flags); the port's build leaves them at their defaults.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // rows per block
constexpr int kPieceRows = 16;  // rows per streamed piece: two per warp
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRing = 4;       // pieces in the ring
constexpr int kCc = 16;        // channels per chunk
constexpr int kMaxK = 16;
constexpr int kMaxHs = 3;      // neighbour steps of 16
constexpr int kMaxH = 44;      // shared memory at K = 16 (the 32-column D tile)
constexpr int kSteps = kRows / kPieceRows;  // pieces per chunk

#ifndef KPCONV_STAGE1_REPS
#define KPCONV_STAGE1_REPS 1  // 0 drops stage 1's MMAs (its copies stay)
#endif
#ifndef KPCONV_STAGE2_REPS
#define KPCONV_STAGE2_REPS 1  // 0 drops stage 2, 2 does its MMAs twice
#endif
#ifndef KPCONV_HALVE_NT
#define KPCONV_HALVE_NT 1  // 0: never halve the D tile for more blocks
#endif

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

struct Layout {
  size_t infl, ring, piece, a2, w, total;
  int a2s;  // stage-2 tile row stride in bf16 (K*16 + 8: conflict-free ldmatrix)
  __host__ __device__ Layout(int h, int kk, int dt) {
    a2s = kk * kCc + 8;
    piece = (size_t)(kPieceRows * h + 16) * 32;  // + 16 zero slots read past the last row
    infl = 0;
    ring = align128((size_t)kRows * h * kk * 2);
    a2 = align128(ring + kRing * piece);
    w = align128(a2 + (size_t)kRows * a2s * 2);
    total = w + (size_t)kk * kCc * dt * 2;  // + W's (K*16) x D_tile tile
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte vector slot of W's tile row q (vpr vectors per row): conflict-free
// for the 8 rows of one ldmatrix
__device__ __forceinline__ int w_swz(int q, int vpr) {
  return vpr >= 8 ? (q & 7) : ((q >> 1) & (vpr - 1));
}

// VEC: bytes per copy of nf (16; 8 when C % 8 != 0). NT: 8-column MMA
// tiles per warp in stage 2 (D_tile = 32 * NT).
template <int VEC, int NT>
__global__ void __launch_bounds__(kThreads, 1)
kpconv_fused_kernel(const __nv_bfloat16* __restrict__ nf,
                    const __nv_bfloat16* __restrict__ infl,
                    const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                    int num_rows, int h, int kk, int c, int d) {
  constexpr int kDt = 32 * NT;
  constexpr int kVpr = kDt / 8;  // 16-byte vectors per W tile row
  constexpr int kSlots = 32 / VEC;  // copies per 32-byte neighbour slot
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(h, kk, kDt);
  const unsigned short* infl_s = reinterpret_cast<const unsigned short*>(smem + lay.infl);
  unsigned char* ring = smem + lay.ring;
  __nv_bfloat16* a2 = reinterpret_cast<__nv_bfloat16*>(smem + lay.a2);
  unsigned char* ws = smem + lay.w;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int t4 = lane & 3;
  const long long r0 = (long long)blockIdx.y * kRows;
  const int nrows = (int)min((long long)kRows, num_rows - r0);
  const int d0 = blockIdx.x * kDt;
  const int nchunks = (c + kCc - 1) / kCc;
  const int steps = nchunks * kSteps;
  const int hsteps = (h + 15) / 16;

  // the ring starts zeroed: slots past the last row, past C and past the
  // last row of the call are never copied into. (Later pieces leave earlier
  // data in such slots: it is finite, and multiplies zero influences or
  // zero weight rows, or lands in output rows that are not stored.)
  for (int i = tid; i < kRing * (int)(lay.piece / 16); i += kThreads) {
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  auto fetch_infl = [&]() {
    const long long bytes = (long long)nrows * h * kk * 2;
    const char* src = reinterpret_cast<const char*>(infl) + r0 * h * kk * 2;
    for (long long i = tid; i * 16 < bytes; i += kThreads) {
      const int n = (int)min(16LL, bytes - i * 16);
      cp_async16(smem + lay.infl + i * 16, src + i * 16, n);
    }
  };
  // q / h for q < 16 * 48 as a multiply-shift (exact there)
  const uint32_t inv_h = (65536u + h - 1) / h;
  auto fetch_piece = [&](int s) {
    const int ch0 = (s / kSteps) * kCc;
    const int g = s % kSteps;
    const int rows = min(kPieceRows, nrows - g * kPieceRows);
    const int slots = min(kSlots, (c - ch0) / (VEC / 2));  // copies with channels < C
    const long long rbase = r0 + g * kPieceRows;
    unsigned char* buf = ring + (s % kRing) * lay.piece;
    for (int i = tid; i < rows * h * slots; i += kThreads) {
      const int q = i / slots, v = i - q * slots;  // slot row q = rr * h + hh
      const int rr = (int)(((uint32_t)q * inv_h) >> 16);
      const __nv_bfloat16* src = nf + ((size_t)((rbase + rr) * h + (q - rr * h)) * c + ch0 +
                                       v * (VEC / 2));
      // 16-byte halves of a slot swap every 4 rows: conflict-free ldmatrix
      const int half = (v * VEC) >> 4;
      unsigned char* dst = buf + (size_t)q * 32 + ((half ^ ((q >> 2) & 1)) << 4) + ((v * VEC) & 15);
      if (VEC == 16) cp_async16(dst, src, 16);
      else cp_async8(dst, src, 8);
    }
  };
  auto fetch_w = [&](int chunk) {
    const int ch0 = chunk * kCc;
    for (int i = tid; i < kk * kCc * kVpr; i += kThreads) {
      const int q = i / kVpr, v = i - q * kVpr;  // tile row q = k * 16 + cc
      const int ch = ch0 + (q & 15), col = d0 + v * 8;
      const bool ok = ch < c && col < d;
      const __nv_bfloat16* src = ok ? w + ((size_t)((q >> 4) * c + ch) * d + col) : w;
      cp_async16(ws + ((size_t)q * kVpr + (v ^ w_swz(q, kVpr))) * 16, src, ok ? 16 : 0);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;

  // prologue: influences, W's first chunk and the first kRing - 1 pieces
  fetch_infl();
  fetch_w(0);
  fetch_piece(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kRing - 1; ++s) {
    if (s < steps) fetch_piece(s);
    cp_async_commit();
  }

  // the influence fragments of this warp's rows (two per piece, kSteps
  // pieces per chunk), built from shared memory in the first chunk and
  // kept in registers for the others
  uint32_t af[kSteps][2][kMaxHs][4];
  const int wm = warp & 1, wn = warp >> 1;
  for (int chunk = 0; chunk < nchunks; ++chunk) {
#pragma unroll
  for (int g = 0; g < kSteps; ++g) {
    const int s = chunk * kSteps + g;
    // one commit group per step: piece s + kRing - 1, and at a chunk's
    // first step the W tile of this chunk (the previous chunk's stage 2 is
    // done with the buffer)
    if (s + kRing - 1 < steps) fetch_piece(s + kRing - 1);
    if (g == 0 && chunk > 0) fetch_w(chunk);
    cp_async_commit();
    cp_async_wait<kRing - 1>();  // piece s (and W of this chunk by its end)
    __syncthreads();

    // stage 1: this warp's two rows of the piece
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      const int rr = warp + sub * kWarps;
      const int rb = g * kPieceRows + rr;
      if (rb < nrows) {
        if (chunk == 0) {
          // A = infl^T (kernel point x neighbour), zero past K and past H
          const unsigned short* ip = infl_s + (size_t)rb * h * kk;
          auto e = [&](int k, int hh) -> uint32_t {
            return (k < kk && hh < h) ? (uint32_t)ip[hh * kk + k] : 0u;
          };
#pragma unroll
          for (int hs = 0; hs < kMaxHs; ++hs) {
            const int h0 = hs * 16;
            uint32_t(&a)[4] = af[g][sub][hs];
            a[0] = e(gid, h0 + 2 * t4) | (e(gid, h0 + 2 * t4 + 1) << 16);
            a[1] = e(gid + 8, h0 + 2 * t4) | (e(gid + 8, h0 + 2 * t4 + 1) << 16);
            a[2] = e(gid, h0 + 2 * t4 + 8) | (e(gid, h0 + 2 * t4 + 9) << 16);
            a[3] = e(gid + 8, h0 + 2 * t4 + 8) | (e(gid + 8, h0 + 2 * t4 + 9) << 16);
          }
        }
        const uint32_t piece = smem_u32(ring + (s % kRing) * lay.piece);
        float wacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int hs = 0; hs < kMaxHs; ++hs) {
          if (hs < hsteps && KPCONV_STAGE1_REPS) {
            // B = nf (neighbour x channel), four 8x8 tiles by one ldmatrix.trans
            const int q = rr * h + hs * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
            const int half = lane >> 4;
            uint32_t b[4];
            ldsm_x4_t(piece + q * 32 + ((half ^ ((q >> 2) & 1)) << 4), b);
            mma16816(wacc[0], af[g][sub][hs], b[0], b[1]);
            mma16816(wacc[1], af[g][sub][hs], b[2], b[3]);
          }
        }
        // round to bf16 in registers, store into the stage-2 tile
        uint32_t* arow = reinterpret_cast<uint32_t*>(a2 + (size_t)rb * lay.a2s);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = nt * 8 + 2 * t4;
          if (gid < kk) arow[(gid * kCc + col) >> 1] = pack_bf16(wacc[nt][0], wacc[nt][1]);
          if (gid + 8 < kk) arow[((gid + 8) * kCc + col) >> 1] = pack_bf16(wacc[nt][2], wacc[nt][3]);
        }
      }
    }

    if (g == kSteps - 1) {
      __syncthreads();
      // stage 2: out[64, D_tile] += weighted[64, K*16] . W[K*16, D_tile]
      const uint32_t a2b = smem_u32(a2), wsb = smem_u32(ws);
#pragma unroll 1
      for (int rep = 0; rep < KPCONV_STAGE2_REPS; ++rep)
      for (int j = 0; j < kk; ++j) {
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int row = wm * 32 + m * 16 + (lane & 15);
          ldsm_x4(a2b + (row * lay.a2s + j * kCc + (lane >> 4) * 8) * 2, a[m]);
        }
        const int q = j * kCc + ((lane >> 3) & 1) * 8 + (lane & 7);
        if (NT == 1) {
          uint32_t b0, b1;
          const int v = wn;
          ldsm_x2_t(wsb + (q * kVpr + (v ^ w_swz(q, kVpr))) * 16, b0, b1);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma16816(acc[m][0], a[m], b0, b1);
        } else {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            const int v = wn * NT + np * 2 + (lane >> 4);
            uint32_t b[4];
            ldsm_x4_t(wsb + (q * kVpr + (v ^ w_swz(q, kVpr))) * 16, b);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma16816(acc[m][2 * np], a[m], b[0], b[1]);
              mma16816(acc[m][2 * np + 1], a[m], b[2], b[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the piece's buffer (and the tiles) may be refilled
  }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = d0 + (wn * NT + n) * 8 + 2 * t4;
      const long long row = r0 + wm * 32 + m * 16 + gid;
      if (col < d) {
        if (row < num_rows)
          *reinterpret_cast<float2*>(out + row * d + col) = make_float2(acc[m][n][0], acc[m][n][1]);
        if (row + 8 < num_rows)
          *reinterpret_cast<float2*>(out + (row + 8) * d + col) =
              make_float2(acc[m][n][2], acc[m][n][3]);
      }
    }
  }
}

template <int VEC, int NT>
int launch(const void* nf, const void* infl, const void* w, float* out, int num_rows, int h,
           int kk, int c, int d, cudaStream_t stream) {
  const Layout lay(h, kk, 32 * NT);
  if (lay.total > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kpconv_fused_kernel<VEC, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d + 32 * NT - 1) / (32 * NT), (num_rows + kRows - 1) / kRows);
  kpconv_fused_kernel<VEC, NT><<<grid, kThreads, lay.total, stream>>>(
      static_cast<const __nv_bfloat16*>(nf), static_cast<const __nv_bfloat16*>(infl),
      static_cast<const __nv_bfloat16*>(w), out, num_rows, h, kk, c, d);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_nt(int nt, const void* nf, const void* infl, const void* w, float* out,
              int num_rows, int h, int kk, int c, int d, cudaStream_t stream) {
  if (nt == 1) return launch<VEC, 1>(nf, infl, w, out, num_rows, h, kk, c, d, stream);
  if (nt == 2) return launch<VEC, 2>(nf, infl, w, out, num_rows, h, kk, c, d, stream);
  return launch<VEC, 4>(nf, infl, w, out, num_rows, h, kk, c, d, stream);
}

}  // namespace

extern "C" int gaussreg_kpconv_fused(const void* nf, const void* infl, const void* w,
                                     float* out, int num_rows, int h, int kk, int c, int d,
                                     void* stream) {
  if (num_rows <= 0 || h <= 0 || h > kMaxH || kk <= 0 || kk > kMaxK || c <= 0 ||
      c % 4 != 0 || d <= 0 || d % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // the copies need 16-byte aligned bases (8 for nf when C % 8 != 0)
  if (((uintptr_t)infl | (uintptr_t)w) % 16 || (uintptr_t)nf % (c % 8 ? 8 : 16) ||
      (uintptr_t)out % 8) {
    return (int)cudaErrorMisalignedAddress;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // D_tile: 32, 64 or 128 columns (each further tile repeats stage 1 on
  // nf from L2); narrower where the tile would not fit in shared memory,
  // and halved once where the grid of one block per SM then still fits in
  // one wave
  const int row_blocks = (num_rows + kRows - 1) / kRows;
  auto blocks = [&](int t) { return (long long)row_blocks * ((d + 32 * t - 1) / (32 * t)); };
  int nt = d <= 32 ? 1 : (d <= 64 ? 2 : 4);
  while (nt > 1 && Layout(h, kk, 32 * nt).total > 227 * 1024) nt /= 2;
  if (KPCONV_HALVE_NT && nt > 1 && blocks(nt / 2) <= sms) nt /= 2;
  cudaStream_t s = (cudaStream_t)stream;
  return c % 8 ? launch_nt<8>(nt, nf, infl, w, out, num_rows, h, kk, c, d, s)
               : launch_nt<16>(nt, nf, infl, w, out, num_rows, h, kk, c, d, s);
}
