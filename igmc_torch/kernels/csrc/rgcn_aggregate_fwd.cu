// Fused R-GCN aggregate (forward) for NVIDIA Hopper, sm_90a, float32.
//
// Replaces the Pallas TPU kernel igmc_tpu/kernels/rgcn_aggregate.py:_kernel
// (launched by _aggregate_fwd). Over dst-block-aligned edges it computes
//
//   out[dst_e] += mask_e * sum_b att[etype_e, b] * (x[src_e] @ basis[b])
//
// for every node row, i.e. the masked segment-SUM of basis-mixed R-GCN
// messages ([num_nodes, Cout] float32; the mean divides by the degree
// outside).
//
// The run form. With W_r = sum_b att[r, b] * basis[b] folded once,
//
//   out[i] = sum_r (sum_{e: dst_e = i, etype_e = r} mask_e * x[src_e]) @ W_r,
//
// so an edge costs Cin adds of its gathered source row, and the products
// shrink to one [Cin] x [Cin, Cout] product per (dst, relation) run: the
// plan (block_align_edges) orders each dst row's edges by relation, so a
// run is a stretch of consecutive slots. At the ML-1M batch that is ~37 K
// runs for ~216 K edges, against 2*B*Cin*Cout operations per edge in the
// TPU's basis-mix form.
//
// What bounds it on this card: the function is bound by device memory
// (the mask over every slot, three index arrays over the real edges, x and
// the output: ~7 MB, 0.002 ms at 3.35 TB/s); its ~1e8 float32 operations
// take less. This kernel is bound by latency instead: each warp walks its
// slots through dependent steps (index loads, then the gather of x[src],
// one Cin-row per edge and ~28 MB at Cin 32, mostly from L2, then the
// run's product), and the grid holds about 12 warps per SM to hide them.
//
// Design:
//   * A thread-block cluster of kCluster = 4 CTAs of 256 threads per
//     `rows`-row output chunk: 200 CTAs of 8 warps at the ML-1M shape
//     (12,800 rows, 50 chunks), at most 2 per SM (128 registers a thread),
//     so every one of the 132 SMs gets work. The cluster's 32 warps take
//     the chunk's 128-slot tiles round robin, so the capacity padding that
//     block_align_edges puts at the tail of chunk 0 costs every warp alike;
//     a warp checks 8 of its tiles at once with one 16-byte mask load per
//     lane and tile, and skips the tiles with no live slot.
//   * A live tile is walked (walk_runs in rgcn_aggregate_common.cuh, the
//     walk the backward kernel shares) as four 32-slot groups, slots on lanes. Ballots
//     find the live slots (mask != 0, relation in this pass) and where a run
//     starts (its (dst, relation) differs from the live slot before it); the
//     rows mask * x[src] of the live slots are gathered, 16 loads in flight,
//     into the warp's staging in shared memory (a row fills Cin lanes
//     rounded up to a power of two, so one load instruction gathers 8 rows
//     at Cin 4); then lanes are the Cin <= 32 channels and each run's rows
//     are summed into a register.
//   * At a run's end, one product with W_r (lanes are the Cout <= 32 output
//     channels, the run sum broadcast by shuffles, W_r read from shared
//     memory) goes into the open row's carry, a register. The product is
//     kept in the walk: deferring the products to a batch (tried) was slower.
//   * Each CTA owns a quarter of the chunk's output rows as a [rows/4, Cout]
//     shared accumulator; a warp adds a finished row's carry to the owning
//     CTA's accumulator through distributed shared memory
//     (cluster.map_shared_rank, shared atomics). The CTAs write their own
//     rows once at the end: no global atomics and no zero fill of `out`
//     (the wrapper allocates it with torch.empty).
//   * W_r is folded in each CTA's prologue from att and basis into shared
//     memory ([R, Cin, Cout], 20 KB at R 5, Cin 32, Cout 32; 63 KB per CTA
//     in all). Where W for all R relations does not fit beside the staging
//     and the accumulator (yahoo_music's R = 71 needs 291 KB at Cin 32, over
//     the 227 KB a block can have), the relations go in groups: the kernel
//     makes one pass over the chunk per group of relations, folding that
//     group's W_r and taking only the live slots whose relation is in it
//     (two passes of 36 relations at R = 71, Cin 32). The launcher sizes the
//     groups from the card's shared memory, so any R runs, with no error and
//     no fallback.
//   * Summation order differs from the plain PyTorch version and shared
//     atomics make it vary between runs: compare with a tolerance.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rgcn_aggregate_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;      // CTAs per output chunk
constexpr int kWarps = 8;        // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kStageWords = kWalkWords;   // per-warp staging of walk_runs

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
rgcn_aggregate_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ att,
                          const float* __restrict__ basis,
                          const int* __restrict__ src,
                          const int* __restrict__ dstl,
                          const int* __restrict__ etype,
                          const float* __restrict__ mask,
                          const int* __restrict__ chunk_of_block,
                          float* __restrict__ out,
                          int cin, int cout, int nb, int nrel, int rows,
                          int nblk, int eblk, int rel_per_pass) {
  extern __shared__ float smem[];
  const int rpc = (rows + kCluster - 1) / kCluster;   // rows each CTA owns
  const int warp = threadIdx.x >> 5;
  float* stage = smem + warp * kStageWords;
  float* s_acc = smem + kWarps * kStageWords;          // [rpc, cout]
  float* s_w = s_acc + rpc * cout;                     // [rel_per_pass, cin, cout]
  __shared__ long long s_range[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int chunk = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31;
  const int wid = rank * kWarps + warp;                // warp index in the cluster
  const int stride = kCluster * kWarps;
  const int o = lane < cout ? lane : 0;                // lanes past cout compute on 0

  chunk_range(chunk_of_block, nblk, chunk, eblk, s_range);
  for (int j = threadIdx.x; j < rpc * cout; j += kThreads) s_acc[j] = 0.f;

  for (int r0 = 0; r0 < nrel; r0 += rel_per_pass) {
    const int nr = min(rel_per_pass, nrel - r0);
    if (r0 > 0) __syncthreads();            // the last pass is done with s_w
    fold_relations(s_w, cout, att, basis, r0, nr, cin, cout, nb);
    // the first time, every CTA's accumulator must be zero before any
    // warp of the cluster adds to it
    if (r0 == 0) cluster.sync(); else __syncthreads();

    float carry = 0.f;    // lane o: the open row's sum of run products
    int open_row = -1;
    // the open row's carry into the accumulator of the CTA that owns it
    auto flush_row = [&]() {
      if (open_row >= 0 && lane < cout) {
        float* acc = cluster.map_shared_rank(s_acc, open_row / rpc);
        atomicAdd(acc + (open_row % rpc) * cout + lane, carry);
      }
      carry = 0.f;
    };
    // each finished (dst, relation) run: its product with W_r into the
    // row's carry (lane i of u holds the run's sum of channel i)
    walk_runs(x, cin, src, dstl, etype, mask, s_range[0], s_range[1], wid, stride,
              r0, nr, stage, [&](int row, int t, float u) {
      if (row != open_row) {
        flush_row();
        open_row = row;
      }
      const float* w = s_w + (t - r0) * cin * cout + o;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int i = 0;
      for (; i + 4 <= cin; i += 4) {
        a0 = fmaf(__shfl_sync(kFull, u, i), w[i * cout], a0);
        a1 = fmaf(__shfl_sync(kFull, u, i + 1), w[(i + 1) * cout], a1);
        a2 = fmaf(__shfl_sync(kFull, u, i + 2), w[(i + 2) * cout], a2);
        a3 = fmaf(__shfl_sync(kFull, u, i + 3), w[(i + 3) * cout], a3);
      }
      for (; i < cin; ++i) a0 = fmaf(__shfl_sync(kFull, u, i), w[i * cout], a0);
      carry += (a0 + a1) + (a2 + a3);
    });
    flush_row();
  }
  cluster.sync();   // every row carry of the cluster has landed

  const int row_lo = rank * rpc, row_hi = min(rows, row_lo + rpc);
  float* out_rows = out + ((long long)chunk * rows + row_lo) * cout;
  for (int j = threadIdx.x; j < (row_hi - row_lo) * cout; j += kThreads) out_rows[j] = s_acc[j];
}

}  // namespace

// Launches the kernel on `stream`: one cluster of kCluster CTAs per output
// chunk (num_nodes / rows of them), relations in as few passes as the
// card's shared memory allows. Returns a cudaError_t as int: 0 on success.
// The caller checks shapes, dtypes, contiguity, cin <= 32, cout <= 32 and
// 1 <= nb <= 8.
extern "C" int rgcn_aggregate_fwd(const float* x, const float* att,
                                  const float* basis, const int* src,
                                  const int* dstl, const int* etype,
                                  const float* mask,
                                  const int* chunk_of_block, float* out,
                                  int num_nodes, int cin, int cout, int nb,
                                  int nrel, int rows, int nblk, int eblk,
                                  void* stream) {
  const int n_chunks = num_nodes / rows;
  if (n_chunks == 0) return 0;
  if (nrel < 1 || nb < 1 || nb > kMaxBases || cin > 32 || cout > 32)
    return (int)cudaErrorInvalidValue;
  // the masks are read 16 bytes at a time from the start of each block
  if (eblk % 4 != 0 || (reinterpret_cast<uintptr_t>(mask) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t fixed =
      sizeof(float) * ((size_t)kWarps * kStageWords + (size_t)((rows + kCluster - 1) / kCluster) * cout);
  const size_t per_rel = sizeof(float) * (size_t)cin * cout;
  const size_t room = (size_t)smem_max - 64;     // the static s_range
  if (fixed + per_rel > room) return (int)cudaErrorInvalidValue;
  const int fit = (int)((room - fixed) / per_rel);
  const int passes = (nrel + fit - 1) / fit;
  const int rel_per_pass = (nrel + passes - 1) / passes;
  const size_t smem = fixed + rel_per_pass * per_rel;
  err = cudaFuncSetAttribute(rgcn_aggregate_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rgcn_aggregate_fwd_kernel<<<n_chunks * kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      x, att, basis, src, dstl, etype, mask, chunk_of_block, out, cin, cout, nb, nrel,
      rows, nblk, eblk, rel_per_pass);
  return (int)cudaGetLastError();
}

extern "C" const char* rgcn_aggregate_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
