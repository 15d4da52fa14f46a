// Row gathers out[r] = table[idx[r]] from an (G, 8) f32 table (probe P1).
//
// Replaces the three Pallas TPU kernels of tools/probe_vmem_gather.py, which
// asked whether a kernel can gather rows of a table by a traced index vector:
//   gaussreg_probe_gather_global  <- `kernel`  (table left in HBM, pltpu.ANY)
//   gaussreg_probe_gather_shared  <- `kernel2` (jnp.take from a table staged
//                                               whole in VMEM)
//   gaussreg_probe_gather_onehot  <- `kernel3` (one-hot (K, G) x (G, C) on
//                                               the matrix unit)
// VMEM is shared memory here (for variant 2 a cluster's distributed shared
// memory). All three give table[idx] bit for bit.
// Precondition: every idx lies in [0, G) (unchecked, as in the probe).
//
// Bound on the card: the K selected rows (32 B each), the K indices and the
// K output rows; at the probe's shape (G = 4096, K = 128) about 8 KB, ~2 ns
// at 3.35 TB/s, out of reach of any launch: every variant is bound by launch
// latency, and variant (2) also by the work its form adds (staging the
// whole 128 KB table before it gathers ~8 KB).
//
// (1) global: one thread per output row, two 16-byte loads.
// (2) shared: the table is staged across a thread-block cluster of
//     kCluster blocks, Hopper's form of "on chip": its distributed shared
//     memory. Block r of a cluster copies rows [r * S, (r + 1) * S) of the
//     table (S = ceil(G / kCluster)) into its own shared memory with one
//     1-D bulk async copy (cp.async.bulk.shared::cluster.global, the TMA's
//     bulk form) that completes on an mbarrier: 16 KB per block at the
//     probe's 128 KB, one instruction. After a cluster barrier, two lanes
//     per 32-byte row (the sector layout of variant 3) read the row's
//     halves from the owning block's slice through
//     cluster_group::map_shared_rank, and a second cluster barrier keeps
//     every block's memory alive until the last remote read. The table is
//     staged once per cluster, so its capacity is the cluster's shared
//     memory (kCluster x 7 263 rows of 32 B, 227 KB per block beside its
//     mbarrier; the wrapper refuses larger tables), and
//     one cluster of up to 1024 threads per block covers K <= 4096 (more
//     clusters, each staging the table, past that).
// (3) onehot: the TPU kernel's one-hot product exists only because Mosaic
//     could not gather by a traced index; on this card the matrix unit has
//     no place in a gather (a one-hot product reads the whole table for
//     every 16 output rows). So it is a direct row gather laid out for
//     whole sectors: two lanes per 32-byte row, one 16-byte __ldg each, so
//     a warp reads 16 whole rows and writes 512 contiguous bytes; both
//     lanes of a row read its index (one broadcast load). One
//     block of up to 1024 threads covers K <= 1024 (a thread takes a second
//     half-row past 512 rows); larger K takes more blocks.
// The plain version of (3) stays the one-hot product (exact: each output
// sums one 1 x value and exact zeros).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 8;                       // row width C (two float4)
constexpr int kMaxSmem = 227 * 1024;           // a block's shared memory on H100
constexpr int kCluster = 8;                    // variant (2): blocks per cluster (portable)
constexpr int kClusterThreads = 1024;          // variant (2): most threads per block
constexpr int kMaxSliceRows = (kMaxSmem - 16) / 32;  // variant (2): beside its mbarrier
constexpr int kGatherThreads = 1024;           // variant (3): one block up to K = 1024

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

__global__ void gather_cluster_kernel(const float4* __restrict__ table,
                                      const int* __restrict__ idx, float4* __restrict__ out,
                                      int g, int k, int slice_rows) {
  extern __shared__ __align__(16) float4 slice[];
  __shared__ __align__(8) unsigned long long bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = rank * slice_rows;
  const int rows = max(0, min(slice_rows, g - row0));
  const uint32_t bar_addr = smem_u32(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_addr),
                 "r"((uint32_t)rows * 32u)
                 : "memory");
    if (rows > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_u32(slice)),
          "l"(table + (size_t)row0 * 2), "r"((uint32_t)rows * 32u), "r"(bar_addr)
          : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar_addr)
        : "memory");
  }
  cluster.sync();  // every block's slice has landed
  const int halves = 2 * k;  // 16-byte half-rows of the output
  const int stride = (int)(gridDim.x * blockDim.x);
  for (int t = (int)(blockIdx.x * blockDim.x + threadIdx.x); t < halves; t += stride) {
    const int i = __ldg(idx + (t >> 1));
    const int owner = i / slice_rows;
    const float4* src = cluster.map_shared_rank(slice, owner);
    out[t] = src[(i - owner * slice_rows) * 2 + (t & 1)];
  }
  cluster.sync();  // no block leaves while another may read its memory
}

__global__ void gather_rows_kernel(const float4* __restrict__ table,
                                   const int* __restrict__ idx, float4* __restrict__ out,
                                   int k) {
  const int halves = 2 * k;  // 16-byte half-rows of the output
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < halves; t += gridDim.x * blockDim.x)
    out[t] = __ldg(table + (size_t)__ldg(idx + (t >> 1)) * 2 + (t & 1));
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
  const int slice_rows = (g + kCluster - 1) / kCluster;
  if (g <= 0 || slice_rows > kMaxSliceRows) return (int)cudaErrorInvalidValue;
  const int smem = slice_rows * kCols * (int)sizeof(float);
  if (k <= 0) return (int)cudaGetLastError();
  static int attr_bytes = 0;  // the limit already set (raised only, once per size)
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  const int per_block = (2 * k + kCluster - 1) / kCluster;  // half-rows per block, one cluster
  const int threads = per_block >= kClusterThreads ? kClusterThreads : (per_block + 31) / 32 * 32;
  const int clusters = (2 * k + kCluster * threads - 1) / (kCluster * threads);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gather_cluster_kernel,
                                             reinterpret_cast<const float4*>(table), idx,
                                             reinterpret_cast<float4*>(out), g, k, slice_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int gaussreg_probe_gather_onehot(const float* table, const int* idx, float* out, int g, int k,
                                 cudaStream_t stream) {
  (void)g;
  if (k > 0) {
    const int threads = k >= kGatherThreads / 2 ? kGatherThreads : (2 * k + 31) / 32 * 32;
    const int blocks = (k + kGatherThreads - 1) / kGatherThreads;
    gather_rows_kernel<<<blocks, threads, 0, stream>>>(reinterpret_cast<const float4*>(table),
                                                       idx, reinterpret_cast<float4*>(out), k);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
