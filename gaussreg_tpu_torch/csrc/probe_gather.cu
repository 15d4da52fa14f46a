// Row gathers out[r] = table[idx[r]] from an (G, 8) f32 table (probe P1).
//
// Replaces the three Pallas TPU kernels of tools/probe_vmem_gather.py, which
// asked whether a kernel can gather rows of a table by a traced index vector:
//   gaussreg_probe_gather_global  <- `kernel`  (table left in HBM, pltpu.ANY)
//   gaussreg_probe_gather_shared  <- `kernel2` (jnp.take from a table staged
//                                               whole in VMEM)
//   gaussreg_probe_gather_onehot  <- `kernel3` (one-hot (K, G) x (G, C) on
//                                               the matrix unit)
// VMEM is shared memory here. All three give table[idx] bit for bit.
// Precondition: every idx lies in [0, G) (unchecked, as in the probe).
//
// Bound on the card: the K selected rows (32 B each), the K indices and the
// K output rows; at the probe's shape (G = 4096, K = 128) about 8 KB, ~2 ns
// at 3.35 TB/s, so every variant is bound by launch latency, and variants
// (2) and (3) also by the work their form adds: (2) copies the whole 128 KB
// table into one block's shared memory first; (3) reads the whole table and
// does 3 x K x G x 8 multiply-adds on tensor cores.
//
// (1) global: one thread per output row, two 16-byte loads.
// (2) shared: each block stages the table in dynamic shared memory with
//     16-byte cp.async copies (above the 48 KB default, so the launcher
//     raises the block's limit with cudaFuncSetAttribute), then one thread
//     per row gathers from it.
// (3) one-hot: mma.sync m16n8k16 bf16 with f32 accumulation. A block owns 16
//     output rows; its 8 warps split G. The one-hot A fragments are built in
//     registers from the indices; B is the table, split in registers into
//     three bf16 parts hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
//     mid), one product each. Each residual is exact in f32 and lo holds the
//     last 8 bits, so hi + mid + lo == x; each output has one nonzero
//     product (1 x part), and every other term adds an exact zero, so the
//     sums are exact whatever the order, and (hi + mid) + lo gives x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;                       // row width C (two float4)
constexpr int kMaxSmem = 227 * 1024;           // a block's shared memory on H100
constexpr int kOnehotWarps = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t onehot_pair(int idx, int col) {
  const unsigned short one = 0x3F80;  // bf16 1.0
  return (idx == col ? one : 0u) | ((idx == col + 1 ? one : 0u) << 16);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Split x into bf16 hi, mid, lo with hi + mid + lo == x exactly.
__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r1);
  lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
}

__global__ void gather_global_kernel(const float4* __restrict__ table,
                                     const int* __restrict__ idx, float4* __restrict__ out,
                                     int k) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= k) return;
  const float4* src = table + (size_t)idx[r] * 2;
  const float4 a = __ldg(src), b = __ldg(src + 1);
  out[2 * r] = a;
  out[2 * r + 1] = b;
}

__global__ void gather_shared_kernel(const float4* __restrict__ table,
                                     const int* __restrict__ idx, float4* __restrict__ out,
                                     int g, int k) {
  extern __shared__ float4 stab[];
  for (int i = threadIdx.x; i < g * 2; i += blockDim.x) cp_async16(stab + i, table + i);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= k) return;
  const int i = idx[r];
  out[2 * r] = stab[2 * i];
  out[2 * r + 1] = stab[2 * i + 1];
}

__global__ void __launch_bounds__(kOnehotWarps * 32)
    gather_onehot_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                         float* __restrict__ out, int g, int k) {
  __shared__ float red[kOnehotWarps][3][16][kCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, q = lane & 3;  // mma group (row / column) and thread in group
  const int row0 = blockIdx.x * 16 + gr;
  const int i0 = row0 < k ? idx[row0] : -1;
  const int i1 = row0 + 8 < k ? idx[row0 + 8] : -1;
  float acc[3][4] = {};
  const int steps = (g + 15) / 16;
  for (int s = warp; s < steps; s += kOnehotWarps) {
    const int kb = s * 16;
    // A (16 x 16 one-hot, row major): rows gr and gr + 8, columns kb + 2q (+1) and +8
    const uint32_t a[4] = {onehot_pair(i0, kb + 2 * q), onehot_pair(i1, kb + 2 * q),
                           onehot_pair(i0, kb + 2 * q + 8), onehot_pair(i1, kb + 2 * q + 8)};
    // B (16 x 8, column major): table rows kb + 2q (+1) and +8 (+9), column gr
    __nv_bfloat16 p[4][3];
    const int rows[4] = {kb + 2 * q, kb + 2 * q + 1, kb + 2 * q + 8, kb + 2 * q + 9};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = rows[j] < g ? __ldg(table + (size_t)rows[j] * kCols + gr) : 0.0f;
      split3(x, p[j][0], p[j][1], p[j][2]);
    }
#pragma unroll
    for (int part = 0; part < 3; ++part)
      mma16816(acc[part], a, pack_bf16(p[0][part], p[1][part]), pack_bf16(p[2][part], p[3][part]));
  }
  // accumulator layout: (row gr, columns 2q, 2q + 1) and (row gr + 8, same columns)
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    red[warp][part][gr][2 * q] = acc[part][0];
    red[warp][part][gr][2 * q + 1] = acc[part][1];
    red[warp][part][gr + 8][2 * q] = acc[part][2];
    red[warp][part][gr + 8][2 * q + 1] = acc[part][3];
  }
  __syncthreads();
  if (threadIdx.x < 16 * kCols) {
    const int r = threadIdx.x / kCols, c = threadIdx.x % kCols;
    float sum[3] = {0.0f, 0.0f, 0.0f};
    for (int w = 0; w < kOnehotWarps; ++w)
      for (int part = 0; part < 3; ++part) sum[part] += red[w][part][r][c];
    const int orow = blockIdx.x * 16 + r;
    if (orow < k) out[(size_t)orow * kCols + c] = (sum[0] + sum[1]) + sum[2];
  }
}

}  // namespace

extern "C" {

int gaussreg_probe_gather_global(const float* table, const int* idx, float* out, int g, int k,
                                 cudaStream_t stream) {
  (void)g;
  if (k > 0)
    gather_global_kernel<<<(k + 127) / 128, 128, 0, stream>>>(
        reinterpret_cast<const float4*>(table), idx, reinterpret_cast<float4*>(out), k);
  return (int)cudaGetLastError();
}

int gaussreg_probe_gather_shared(const float* table, const int* idx, float* out, int g, int k,
                                 cudaStream_t stream) {
  const int smem = g * kCols * (int)sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int attr_bytes = 0;  // the limit already set (raised only, once per size)
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  if (k > 0)
    gather_shared_kernel<<<(k + 255) / 256, 256, smem, stream>>>(
        reinterpret_cast<const float4*>(table), idx, reinterpret_cast<float4*>(out), g, k);
  return (int)cudaGetLastError();
}

int gaussreg_probe_gather_onehot(const float* table, const int* idx, float* out, int g, int k,
                                 cudaStream_t stream) {
  if (k > 0)
    gather_onehot_kernel<<<(k + 15) / 16, kOnehotWarps * 32, 0, stream>>>(table, idx, out, g, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
