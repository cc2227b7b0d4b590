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
// What bounds it on this card: the function itself is bound by device
// memory (3.35 TB/s). Folding W_r = att @ basis first, or transforming each
// node once per relation and gather-summing, leaves 2*Cin*Cout or fewer
// float32 operations per edge, under the ~16 bytes of index and mask each
// edge slot costs. This kernel's basis-mix form spends 2*B*Cin*Cout = 8
// KFLOP per edge at IGMC's widths (B = 4 bases, Cin 32, Cout 32), so its own
// arithmetic on the float32 CUDA cores (67 TFLOP/s peak) is what bounds it:
// about 12 times the function's floor at Cin 32. The gathers hit L2 (x is
// a few MB at most).
//
// Design (simple first, not yet fast):
//   * One CTA per `rows`-row output chunk. block_align_edges packs each
//     chunk's edges into consecutive blocks (chunk_of_block is
//     nondecreasing, every chunk owns at least one block), so a CTA owns its
//     output rows outright: no global atomics and no zero-fill pass; the
//     wrapper allocates the output with torch.empty. A chunk that owned no
//     block would still be written (with zeros).
//   * Unlike the TPU kernel, the gathers x[src] and att[etype] happen inside
//     the kernel (Mosaic could not express them; CUDA can).
//   * basis [B, Cin, Cout], att [R, B] and a [rows, Cout] float32
//     accumulator live in dynamic shared memory: 48 KB + 1 KB at rows 256,
//     over the 48 KB static limit, hence cudaFuncSetAttribute below.
//     The basis-mix form is kept (W_r = att @ basis is not pre-folded):
//     with R = 71 relations W_r would no longer fit in shared memory.
//   * The CTA's 32 warps take 128-slot groups of the chunk's edges round
//     robin, so the padding at the tail of a chunk (block_align_edges puts
//     all extra blocks in chunk 0) costs every warp alike; a warp ballot on
//     the mask skips a padding row of 32 slots in one step. Lanes are the
//     Cout <= 32 output channels. 32 edges' indices are loaded coalesced and
//     broadcast by shuffles; four edges at a time, x[src] is loaded one
//     element per lane and broadcast by shuffles, and lane o accumulates
//     h[k][b] = sum_i x_i * basis[b, i, o] (each basis value read from shared
//     memory serves four edges; the number of bases is a template
//     parameter, 1 to 8, so h stays in registers), then
//     msg = sum_b att[etype, b] * h[k][b]. Edges are dst-sorted, so a
//     register carries the running sum of one dst row and is added to the
//     shared accumulator (shared-memory atomicAdd) only when the row
//     changes. Masked edges contribute nothing.
//   * Summation order differs from the plain PyTorch version and shared
//     atomics make it vary between runs: compare with a tolerance.
// Making it fast (wgmma/mma tiles, TMA, persistent CTAs) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 128;      // edge slots a warp examines per step (4 x 32)
constexpr int kQuad = 4;         // edges whose messages a warp computes at once
constexpr unsigned kFull = 0xffffffffu;

template <int NB>
__global__ void __launch_bounds__(kThreads)
rgcn_aggregate_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ att,
                          const float* __restrict__ basis,
                          const int* __restrict__ src,
                          const int* __restrict__ dstl,
                          const int* __restrict__ etype,
                          const float* __restrict__ mask,
                          const int* __restrict__ chunk_of_block,
                          float* __restrict__ out,
                          int cin, int cout, int nrel, int rows,
                          int nblk, int eblk) {
  extern __shared__ float smem[];
  float* s_basis = smem;                       // [NB, cin, cout]
  float* s_att = s_basis + NB * cin * cout;    // [nrel, NB]
  float* s_acc = s_att + nrel * NB;            // [rows, cout]
  __shared__ int s_range[2];                   // this chunk's block range

  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid < 2) {
    // lower_bound(chunk_of_block, chunk + tid): first block of chunk (tid 0)
    // and first block past it (tid 1)
    const int key = chunk + tid;
    int lo = 0, hi = nblk;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (chunk_of_block[mid] < key) lo = mid + 1; else hi = mid;
    }
    s_range[tid] = lo;
  }
  for (int i = tid; i < NB * cin * cout; i += kThreads) s_basis[i] = basis[i];
  for (int i = tid; i < nrel * NB; i += kThreads) s_att[i] = att[i];
  for (int i = tid; i < rows * cout; i += kThreads) s_acc[i] = 0.f;
  __syncthreads();

  const long long e_begin = (long long)s_range[0] * eblk;
  const long long e_end = (long long)s_range[1] * eblk;
  const bool lane_out = lane < cout;
  const int o = lane_out ? lane : 0;   // lanes past cout compute on column 0
  int cur_row = -1;                    // dst row the carry belongs to
  float carry = 0.f;

  // Warps take 128-slot groups round-robin, so padding (masked slots, all
  // at the tail of a chunk's range) costs every warp alike and is skipped
  // by a ballot; inside a group, slots go in ascending (dst-sorted) order.
  for (long long g = e_begin + (long long)warp * kGroup; g < e_end;
       g += (long long)kWarps * kGroup) {
    for (int sub = 0; sub < kGroup / 32; ++sub) {
      const long long e = g + sub * 32 + lane;
      const bool valid = e < e_end;
      const float my_m = valid ? mask[e] : 0.f;
      if (__ballot_sync(kFull, my_m != 0.f) == 0u) continue;   // all padding
      const int my_src = valid ? src[e] : 0;
      const int my_dst = valid ? dstl[e] : 0;
      const int my_t = valid ? etype[e] : 0;

      for (int j0 = 0; j0 < 32; j0 += kQuad) {
        float m[kQuad], h[kQuad][NB];
        int s[kQuad], d[kQuad], t[kQuad];
#pragma unroll
        for (int k = 0; k < kQuad; ++k) {
          m[k] = __shfl_sync(kFull, my_m, j0 + k);
          s[k] = __shfl_sync(kFull, my_src, j0 + k);
          d[k] = __shfl_sync(kFull, my_dst, j0 + k);
          t[k] = __shfl_sync(kFull, my_t, j0 + k);
#pragma unroll
          for (int b = 0; b < NB; ++b) h[k][b] = 0.f;
        }
        if (m[0] == 0.f && m[1] == 0.f && m[2] == 0.f && m[3] == 0.f) continue;
        // h[k][b] = sum_i x[s_k, i] * basis[b, i, o]
        for (int i0 = 0; i0 < cin; i0 += 32) {
          float xv[kQuad];
#pragma unroll
          for (int k = 0; k < kQuad; ++k)
            xv[k] = (i0 + lane < cin) ? __ldg(x + (long long)s[k] * cin + i0 + lane) : 0.f;
          const int ni = min(32, cin - i0);
          for (int ii = 0; ii < ni; ++ii) {
            float bas[NB];
#pragma unroll
            for (int b = 0; b < NB; ++b) bas[b] = s_basis[(b * cin + i0 + ii) * cout + o];
#pragma unroll
            for (int k = 0; k < kQuad; ++k) {
              const float xi = __shfl_sync(kFull, xv[k], ii);
#pragma unroll
              for (int b = 0; b < NB; ++b) h[k][b] = fmaf(xi, bas[b], h[k][b]);
            }
          }
        }
        // msg_k = sum_b att[t_k, b] * h[k][b]; fold into the row carry in order
#pragma unroll
        for (int k = 0; k < kQuad; ++k) {
          if (m[k] == 0.f) continue;   // warp-uniform: padding slot
          float msg = 0.f;
#pragma unroll
          for (int b = 0; b < NB; ++b) msg = fmaf(s_att[t[k] * NB + b], h[k][b], msg);
          if (d[k] != cur_row) {
            if (cur_row >= 0 && lane_out) atomicAdd(&s_acc[cur_row * cout + lane], carry);
            cur_row = d[k];
            carry = 0.f;
          }
          carry = fmaf(m[k], msg, carry);
        }
      }
    }
  }
  if (cur_row >= 0 && lane_out) atomicAdd(&s_acc[cur_row * cout + lane], carry);
  __syncthreads();

  float* out_chunk = out + (long long)chunk * rows * cout;
  for (int i = tid; i < rows * cout; i += kThreads) out_chunk[i] = s_acc[i];
}

template <int NB>
int launch(const float* x, const float* att, const float* basis, const int* src,
           const int* dstl, const int* etype, const float* mask,
           const int* chunk_of_block, float* out, int n_chunks, int cin,
           int cout, int nrel, int rows, int nblk, int eblk, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rgcn_aggregate_fwd_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rgcn_aggregate_fwd_kernel<NB><<<n_chunks, kThreads, smem, stream>>>(
      x, att, basis, src, dstl, etype, mask, chunk_of_block, out, cin, cout, nrel,
      rows, nblk, eblk);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` with one CTA per output chunk
// (num_nodes / rows of them). Returns a cudaError_t as int: 0 on success.
// The caller checks shapes, dtypes, contiguity, cout <= 32 and
// 1 <= nb <= 8 (the number of bases is a template parameter).
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
  const size_t smem =
      sizeof(float) * ((size_t)nb * cin * cout + (size_t)nrel * nb + (size_t)rows * cout);
  cudaStream_t st = (cudaStream_t)stream;
#define IGMC_LAUNCH(NB_)                                                               \
  case NB_:                                                                            \
    return launch<NB_>(x, att, basis, src, dstl, etype, mask, chunk_of_block, out,     \
                       n_chunks, cin, cout, nrel, rows, nblk, eblk, smem, st);
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

extern "C" int rgcn_aggregate_fwd_max_smem(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

extern "C" const char* rgcn_aggregate_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
