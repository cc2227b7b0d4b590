// Fused R-GCN aggregate (backward) for NVIDIA Hopper, sm_90a, float32.
//
// Replaces the Pallas TPU kernel igmc_tpu/kernels/rgcn_aggregate.py:
// _bwd_kernel (launched by _aggregate_bwd), the backward of
// rgcn_aggregate_pallas_train. For the output gradient g [N, Cout] of
//
//   out[dst_e] += mask_e * sum_b att[etype_e, b] * (x[src_e] @ basis[b])
//
// it computes, in one pass over the src-sorted twin plan
// (block_align_edges_transposed), with gv_e = mask_e * g[dst_e],
// ae_e = att[etype_e] and t_b = gv_e @ basis[b]^T:
//
//   dx[src_e]        += sum_b ae_e[b] * t_b                (if dx is wanted)
//   datt[etype_e, b] += <t_b, x[src_e]>
//   dbasis[b]        += (ae_e[b] * x[src_e])^T outer gv_e
//
// What bounds it on this card: the function's least work (fold
// dW_r = sum_e x[src] outer gv per relation, or transform each node's g once
// per relation for dx) is about 2.8e8 float32 operations and 9 MB at the
// ML-1M batch shape, so it is bound by operations on the CUDA cores
// (67 TFLOP/s), at a few microseconds. This kernel keeps the TPU's basis
// form: 2*B*Cin*Cout operations per edge for the t_b products (8 KFLOP at
// B 4, Cin 32, Cout 32), plus one [Cin] x [Cout] outer product per run of
// edges that share a source row for dbasis. The gathers hit L2.
//
// Design (simple first, not yet fast):
//   * One CTA per `rows`-row chunk of SOURCE rows. The twin plan packs a
//     chunk's edges into consecutive blocks (found by binary search on
//     chunk_of_block, as in the forward kernel), so the CTA owns its dx rows
//     outright: a [rows, Cin] shared accumulator written once, no global
//     atomics and no zero fill for dx; the wrapper allocates it with
//     torch.empty. With dx not wanted (layer 1's one-hot input) it is
//     neither accumulated nor written.
//   * dbasis and datt are sums over every edge of the batch. On the TPU they
//     were one output block revisited by the sequential grid; here the CTAs
//     run in parallel and in no order. Each CTA accumulates a
//     [B, Cin, Cout] dbasis partial and [R, B, 32] per-lane datt partials in
//     shared memory and adds them to the outputs (zeroed by the wrapper)
//     with one global atomicAdd per element at its end. The TPU's per-slot
//     dae [B, Ep] array is never written.
//   * The basis form is kept (no per-relation dW_r accumulator), so shared
//     memory does not grow with R beyond att and the datt partials: basis^T
//     16 KB + dbasis 16 KB + dx 32 KB + ~3 KB at R 5 — over the 48 KB
//     static limit, hence cudaFuncSetAttribute below.
//   * The CTA's 32 warps take 128-slot groups round robin, and a warp ballot
//     on the mask skips a 32-slot padding row in one step: the capacity
//     padding that block_align_edges puts in chunk 0 costs every warp alike.
//     32 edges' indices are loaded coalesced and broadcast by shuffles; four
//     edges at a time, lane o loads g[dst][o] and lane i loads x[src][i],
//     and lane i accumulates t[k][b] = sum_o gv_k[o] * basis[b, i, o] (gv
//     broadcast by shuffles, each shared-memory basis value serving four
//     edges; the number of bases is a template parameter, 1 to 8, so t stays
//     in registers). Lanes are the Cin <= 32 input channels.
//   * Edges are src-sorted, so a warp carries the running dx row sum and
//     u_b = sum_e ae_e[b] * gv_e of one source row in registers; when the
//     row changes it adds the carry to the dx accumulator and
//     x[src] outer u_b to the dbasis partial (shared-memory atomicAdd).
//     datt's <t_b, x[src]> is added per edge into lane-private partials,
//     summed over lanes at the end.
//   * Summation order differs from the plain PyTorch version and atomics
//     make it vary between runs: compare with a tolerance.
// Making it fast (the least-work form, tensor-core tiles, more CTAs than
// chunks) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 128;      // edge slots a warp examines per step (4 x 32)
constexpr int kQuad = 4;         // edges a warp computes at once
constexpr unsigned kFull = 0xffffffffu;

template <int NB>
__global__ void __launch_bounds__(kThreads)
rgcn_aggregate_bwd_kernel(const float* __restrict__ g,
                          const float* __restrict__ x,
                          const float* __restrict__ att,
                          const float* __restrict__ basis,
                          const int* __restrict__ gdst,
                          const int* __restrict__ srcl,
                          const int* __restrict__ etype,
                          const float* __restrict__ mask,
                          const int* __restrict__ chunk_of_block,
                          float* __restrict__ dx,
                          float* __restrict__ datt,
                          float* __restrict__ dbasis,
                          int cin, int cout, int nrel, int rows,
                          int nblk, int eblk) {
  extern __shared__ float smem[];
  float* s_basisT = smem;                        // [NB, cout, cin]
  float* s_att = s_basisT + NB * cout * cin;     // [nrel, NB]
  float* s_db = s_att + nrel * NB;               // [NB, cin, cout]
  float* s_dattp = s_db + NB * cin * cout;       // [nrel * NB, 32]
  float* s_dx = s_dattp + nrel * NB * 32;        // [rows, cin]
  __shared__ int s_range[2];                     // this chunk's block range

  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool want_dx = dx != nullptr;

  if (tid < 2) {
    // lower_bound(chunk_of_block, chunk + tid)
    const int key = chunk + tid;
    int lo = 0, hi = nblk;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (chunk_of_block[mid] < key) lo = mid + 1; else hi = mid;
    }
    s_range[tid] = lo;
  }
  const int bio = cin * cout;
  for (int j = tid; j < NB * bio; j += kThreads) {
    const int b = j / bio, io = j - b * bio, i = io / cout, o = io - i * cout;
    s_basisT[(b * cout + o) * cin + i] = basis[j];
    s_db[j] = 0.f;
  }
  for (int j = tid; j < nrel * NB; j += kThreads) s_att[j] = att[j];
  for (int j = tid; j < nrel * NB * 32; j += kThreads) s_dattp[j] = 0.f;
  if (want_dx)
    for (int j = tid; j < rows * cin; j += kThreads) s_dx[j] = 0.f;
  __syncthreads();

  const long long e_begin = (long long)s_range[0] * eblk;
  const long long e_end = (long long)s_range[1] * eblk;
  const bool lane_in = lane < cin;     // lane as input channel i
  const bool lane_out = lane < cout;   // lane as output channel o
  const int i = lane_in ? lane : 0;    // lanes past cin compute on column 0
  const long long row0 = (long long)chunk * rows;

  int cur_row = -1;       // local src row the carries belong to
  float carry = 0.f;      // sum_b ae[b] * t_b over the row's edges (lane i)
  float xcur = 0.f;       // x[src][lane] of that row
  float u[NB];            // sum ae[b] * gv over the row's edges (lane o)
#pragma unroll
  for (int b = 0; b < NB; ++b) u[b] = 0.f;

  // adds the current row's carries to the dx accumulator and the dbasis
  // partial (warp-uniform: every lane calls it at the same point)
  auto flush = [&]() {
    if (cur_row < 0) return;
    if (want_dx && lane_in) atomicAdd(&s_dx[cur_row * cin + lane], carry);
    for (int ii = 0; ii < cin; ++ii) {
      const float xi = __shfl_sync(kFull, xcur, ii);
      if (lane_out) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
          atomicAdd(&s_db[(b * cin + ii) * cout + lane], xi * u[b]);
      }
    }
  };

  for (long long g0 = e_begin + (long long)warp * kGroup; g0 < e_end;
       g0 += (long long)kWarps * kGroup) {
    for (int sub = 0; sub < kGroup / 32; ++sub) {
      const long long e = g0 + sub * 32 + lane;
      const bool valid = e < e_end;
      const float my_m = valid ? mask[e] : 0.f;
      if (__ballot_sync(kFull, my_m != 0.f) == 0u) continue;   // all padding
      const int my_d = valid ? gdst[e] : 0;
      const int my_s = valid ? srcl[e] : 0;
      const int my_t = valid ? etype[e] : 0;

      for (int j0 = 0; j0 < 32; j0 += kQuad) {
        float m[kQuad], gv[kQuad], xv[kQuad], t[kQuad][NB];
        int s[kQuad], ty[kQuad];
        bool any = false;
#pragma unroll
        for (int k = 0; k < kQuad; ++k) {
          m[k] = __shfl_sync(kFull, my_m, j0 + k);
          s[k] = __shfl_sync(kFull, my_s, j0 + k);
          ty[k] = __shfl_sync(kFull, my_t, j0 + k);
          const int d = __shfl_sync(kFull, my_d, j0 + k);
          any = any || m[k] != 0.f;
          gv[k] = (lane_out && m[k] != 0.f)
                      ? m[k] * __ldg(g + (long long)d * cout + lane) : 0.f;
          xv[k] = (lane_in && m[k] != 0.f)
                      ? __ldg(x + (row0 + s[k]) * cin + lane) : 0.f;
#pragma unroll
          for (int b = 0; b < NB; ++b) t[k][b] = 0.f;
        }
        if (!any) continue;   // warp-uniform
        // t[k][b] = sum_o gv_k[o] * basis[b, i, o]
        for (int o = 0; o < cout; ++o) {
          float bas[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) bas[b] = s_basisT[(b * cout + o) * cin + i];
#pragma unroll
          for (int k = 0; k < kQuad; ++k) {
            const float go = __shfl_sync(kFull, gv[k], o);
#pragma unroll
            for (int b = 0; b < NB; ++b) t[k][b] = fmaf(go, bas[b], t[k][b]);
          }
        }
#pragma unroll
        for (int k = 0; k < kQuad; ++k) {
          if (m[k] == 0.f) continue;   // warp-uniform: padding or dropped
          const float* a = s_att + ty[k] * NB;
          // datt partials: lane i adds t_b[i] * x[src][i] (0 past cin)
#pragma unroll
          for (int b = 0; b < NB; ++b)
            atomicAdd(&s_dattp[(ty[k] * NB + b) * 32 + lane], t[k][b] * xv[k]);
          if (s[k] != cur_row) {
            flush();
            cur_row = s[k];
            carry = 0.f;
            xcur = xv[k];
#pragma unroll
            for (int b = 0; b < NB; ++b) u[b] = 0.f;
          }
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            carry = fmaf(a[b], t[k][b], carry);
            u[b] = fmaf(a[b], gv[k], u[b]);
          }
        }
      }
    }
  }
  flush();
  __syncthreads();

  if (want_dx) {
    float* dx_chunk = dx + row0 * cin;
    for (int j = tid; j < rows * cin; j += kThreads) dx_chunk[j] = s_dx[j];
  }
  for (int j = tid; j < NB * bio; j += kThreads) atomicAdd(&dbasis[j], s_db[j]);
  for (int j = tid; j < nrel * NB; j += kThreads) {
    float sum = 0.f;
    for (int l = 0; l < 32; ++l) sum += s_dattp[j * 32 + l];
    atomicAdd(&datt[j], sum);
  }
}

template <int NB>
int launch(const float* g, const float* x, const float* att, const float* basis,
           const int* gdst, const int* srcl, const int* etype, const float* mask,
           const int* chunk_of_block, float* dx, float* datt, float* dbasis,
           int n_chunks, int cin, int cout, int nrel, int rows, int nblk,
           int eblk, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rgcn_aggregate_bwd_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rgcn_aggregate_bwd_kernel<NB><<<n_chunks, kThreads, smem, stream>>>(
      g, x, att, basis, gdst, srcl, etype, mask, chunk_of_block, dx, datt, dbasis,
      cin, cout, nrel, rows, nblk, eblk);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` with one CTA per source-row chunk
// (num_nodes / rows of them). `datt` and `dbasis` must be zeroed; `dx` is
// written whole when need_dx is nonzero and ignored otherwise. Returns a
// cudaError_t as int: 0 on success. The caller checks shapes, dtypes,
// contiguity, cin <= 32, cout <= 32 and 1 <= nb <= 8 (the number of bases
// is a template parameter).
extern "C" int rgcn_aggregate_bwd(const float* g, const float* x,
                                  const float* att, const float* basis,
                                  const int* gdst, const int* srcl,
                                  const int* etype, const float* mask,
                                  const int* chunk_of_block, float* dx,
                                  float* datt, float* dbasis, int num_nodes,
                                  int cin, int cout, int nb, int nrel, int rows,
                                  int nblk, int eblk, int need_dx, void* stream) {
  const int n_chunks = num_nodes / rows;
  if (n_chunks == 0) return 0;
  const size_t smem = sizeof(float) * (2 * (size_t)nb * cin * cout + (size_t)nrel * nb +
                                       (size_t)rows * cin + 32 * (size_t)nrel * nb);
  cudaStream_t st = (cudaStream_t)stream;
  float* dx_or_null = need_dx ? dx : nullptr;
#define IGMC_LAUNCH(NB_)                                                             \
  case NB_:                                                                          \
    return launch<NB_>(g, x, att, basis, gdst, srcl, etype, mask, chunk_of_block,    \
                       dx_or_null, datt, dbasis, n_chunks, cin, cout, nrel, rows,    \
                       nblk, eblk, smem, st);
  switch (nb) {
    IGMC_LAUNCH(1)
    IGMC_LAUNCH(2)
    IGMC_LAUNCH(3)
    IGMC_LAUNCH(4)
    IGMC_LAUNCH(5)
    IGMC_LAUNCH(6)
    IGMC_LAUNCH(7)
    IGMC_LAUNCH(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef IGMC_LAUNCH
}

extern "C" int rgcn_aggregate_bwd_max_smem(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

extern "C" const char* rgcn_aggregate_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
