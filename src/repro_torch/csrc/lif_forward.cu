// Forward Engine without plasticity: psum-stationary product, LIF neuron with
// hard reset, post-trace update.
//
//   lif_forward_f32  replaces src/repro/kernels/lif/kernel.py:47
//   lif_forward_bf16 lif_forward_pallas (_lif_kernel :21), in float32 and
//                    in bfloat16 (the Pallas body's generic dtype,
//                    :36-44): bfloat16 operands are promoted to float32 on
//                    load, the product accumulates in float32 over the
//                    whole K, and each output is rounded once on store.
//
// What bounds it on an H100: bytes.  The product reads w (K, M) once; at
// the online-MNIST layer 784 x 1024 and B = 1 that is ~3.2 MB, ~1 us at
// 3.35 TB/s, against 2 operations per weight and row.  At 1024 -> 10 the
// 40 KB of w take a launch's latency and one round trip.
//
// Design (the launch is kernels/lif/kernel.py lif_forward_plan's: the
// frozen shared step's grid, its own threads; this file checks its
// shared-memory count).  The Forward Engine is csrc/forward.cuh's, the one
// the plastic step (shared_step.cu) runs:
//  * The grid is column tiles x fan-in shares: a CTA owns `cols` columns of
//    `rows` consecutive input rows; where the tiles leave SMs idle (the
//    readout, M = 10) the fan-in is cut across a thread-block cluster of
//    `split` CTAs, one column tile each.
//  * Bytes in flight do not depend on warps: at the start a CTA issues its
//    whole w slab on one mbarrier (2-D TMA boxes, one bulk copy, or cp.async
//    pieces; plain loads where rows are not 4-byte aligned), stages the
//    input events of its rows beside it, and fetches its first neurons'
//    membranes and traces meanwhile.
//  * 128 to 512 threads, about 16 multiply-adds of a pass each: a lane
//    takes up to 4 weights of a row over a few strided rows, for up to 8
//    batch rows at once (the events staged with 8 loads in flight a
//    thread before their stores); the lanes fold by a
//    reduce-scatter of warp shuffles, the warps in warp order, the
//    cluster's CTAs in rank order through distributed shared memory.  Only
//    rank 0 runs the neuron and trace update and stores: nothing after it
//    reads the post traces.  Batches of more than 8 rows take the same
//    steps 8 rows at a time.
// Arithmetic: -fmad=false, the trace update an explicit __fmaf_rn (the
// multiply-add XLA contracts it into); the psum folds in one fixed order,
// so every run gives the same bits.
#include "forward.cuh"

// Arguments of one launch; mirrored by kernels/lif/kernel.py _LifArgs.
// Every tensor is float32, or every one bfloat16.
struct LifArgs {
  const void* x;            // (B, K)
  const void* w;            // (K, M)
  const void* v;            // (B, M)
  const void* trace;        // (B, M)
  void* spikes;             // (B, M) out
  void* v_out;              // (B, M) out
  void* trace_out;          // (B, M) out
  int batch, k, m;
  ff::FParams f;
  // the launch's plan (kernel.py lif_forward_plan)
  int cols;                 // columns of a tile
  int split;                // CTAs of a cluster sharing a tile's fan-in
  int rows;                 // input rows of a CTA (the last: what is left)
  int threads;
  int vec;                  // weights of a 16-byte piece (1: one weight)
  int chunk_rows;           // rows of a TMA box
  int stage_x;              // 1: the rows' input events staged
  int w_route, w_width;     // slab.cuh Route and piece bytes of w
  int smem;                 // the wrapper's count of shared memory
};

namespace {

struct LifParams {
  LifArgs a;
  CUtensorMap w_map;        // w as (K, M), where its route is kTma
};

// Shared-memory layout (bytes); kernel.py lif_forward_plan counts the same
// and the launcher refuses a launch whose total disagrees.
struct LifLayout {
  size_t w, xs, ps, red, bar, total;
  int pw;
};

__host__ __device__ inline LifLayout lif_layout(const LifArgs& a, int e) {
  LifLayout l;
  const size_t c = a.cols, R = a.chunk_rows;
  const size_t chunks = (a.rows + a.chunk_rows - 1) / a.chunk_rows;
  const size_t pass = a.batch < kChunk ? a.batch : kChunk;  // rows a pass
  l.pw = a.w_route == kBulk ? a.m : a.cols;
  size_t off = 0;
  l.w = off;
  off += align_up(chunks * R * l.pw * e, 128);
  l.xs = off;
  if (a.stage_x) off += align_up((size_t)a.batch * a.rows * e, 16);
  l.ps = off;
  off += align_up(pass * c * 4, 16);
  l.red = off;
  off += align_up((size_t)(a.threads / 32) * kChunk * c * 4, 16);
  l.bar = off;
  off += 16;
  l.total = off + 128;                // slack to align the base to 128
  return l;
}

// T: float | bfloat16; V: weights of a 16-byte piece (1 where M's rows are
// not in 16-byte pieces).
template <typename T, int V>
__global__ void __launch_bounds__(512, 1)
lif_forward_kernel(const __grid_constant__ LifParams p) {
  using ff::cvt;
  const LifArgs& a = p.a;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  constexpr int e = sizeof(T);
  constexpr int kF = V < 4 ? V : 4;       // weights of a lane's piece
  const LifLayout lay = lif_layout(a, e);

  // ---- this CTA: columns [col0, col0 + own) of rows [r0, r0 + rows) -----
  const int B = a.batch, K = a.k, M = a.m, c = a.cols, R = a.chunk_rows;
  const int split = a.split, rank = split > 1 ? cluster_rank() : 0;
  const int col0 = blockIdx.x * c, own = min(c, M - col0);
  const int r0 = rank * a.rows, rows = min(a.rows, K - r0);
  const int chunks = (rows + R - 1) / R;
  const int tid = threadIdx.x, T_ = blockDim.x;
  T* ws = (T*)(smem + lay.w);
  T* xs_s = (T*)(smem + lay.xs);
  float* ps = (float*)(smem + lay.ps);
  float* red = (float*)(smem + lay.red);
  const uint32_t bar_w = smem_u32(smem + lay.bar);

  // ---- issue every load at once --------------------------------------------
  if (tid == 0) {
    mbar_init(bar_w, a.w_route == kCpAsync ? T_ : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  issue_slab((unsigned char*)ws, a.w, &p.w_map, a.w_route, a.w_width, bar_w,
             r0, rows, M, c, own, col0, R, chunks, e, tid, T_);
  const T* x_in = (const T*)a.x;
  if (a.stage_x) stage_rows(xs_s, x_in, B, rows, K, r0, tid, T_);
  if (a.w_route == kL2)
    fill_slab(ws, (const T*)a.w, r0, rows, M, c, own, col0, tid, T_);
  // rank 0: the thread's first neuron's operands, fetched while w lands
  const bool lead = rank == 0;
  const T* v_in = (const T*)a.v;
  const T* tr_in = (const T*)a.trace;
  float v0 = 0.0f, tr0 = 0.0f;
  const bool have0 = lead && tid < min(B, kChunk) * c && tid % c < own;
  if (have0) {
    const long g = (long)(tid / c) * M + col0 + tid % c;
    v0 = cvt<float>(v_in[g]);
    tr0 = cvt<float>(tr_in[g]);
  }
  const T* xs = a.stage_x ? xs_s : x_in + r0;
  const long xstride = a.stage_x ? rows : K;
  sync_first(T_);
  if (staged(a.w_route)) mbar_wait(bar_w, 0);

  // ---- 8 batch rows at a time: psums, the cluster's fold, the neurons ------
  const uint32_t ps_addr = smem_u32(ps);
  for (int b0 = 0; b0 < B; b0 += kChunk) {
    const int nb = min(kChunk, B - b0);
    forward_psums<false, kF>(ps, red, ws, lay.pw, xs + b0 * xstride, xstride,
                             rows, nb, c, tid, T_);
    if (split > 1) {
      cluster_arrive();
      cluster_wait();
    }
    if (lead) {
      for (int i = tid; i < nb * c; i += T_) {
        const int u = i / c, j = i - u * c;
        if (j >= own) continue;
        const float s =
            split > 1 ? fold_peers<false, float>(ps_addr + 4 * i, split)
                      : ps[i];
        const long g = (long)(b0 + u) * M + col0 + j;
        const bool first = b0 == 0 && i == tid && have0;
        float ev, vn;
        ff::neuron_f(first ? v0 : cvt<float>(v_in[g]), s, true, a.f, &ev,
                     &vn);
        ((T*)a.spikes)[g] = cvt<T>(ev);
        ((T*)a.v_out)[g] = cvt<T>(vn);
        ((T*)a.trace_out)[g] = cvt<T>(__fmaf_rn(
            a.f.decay, first ? tr0 : cvt<float>(tr_in[g]), ev));
      }
    }
    // rank 0 is done with the peers' partials before any CTA overwrites
    // them or leaves (within a CTA, forward_psums' first barrier orders
    // this epilogue before the next chunk's partials)
    if (split > 1) {
      cluster_arrive();
      cluster_wait();
    }
  }
}

// ---- host side ------------------------------------------------------------

// The plan's constraints (kernel.py lif_forward_plan builds them).
bool valid(const LifArgs* a, int pv, int e) {
  if (!route_ok(a->w_route, a->w_width, a->k, a->m, a->cols, e) ||
      !(staged(a->w_route) || a->w_route == kL2))
    return false;
  const int c = a->cols, v = a->vec;
  const int pieces = v > 0 ? c / v : 0;
  return a->batch >= 1 && a->k >= 1 && a->m >= 1 && (v == 1 || v == pv) &&
         c >= v && c % v == 0 && pieces <= 32 &&
         (pieces & (pieces - 1)) == 0 && a->threads >= 32 &&
         a->threads <= 512 && a->threads % 32 == 0 &&
         a->threads % pieces == 0 && a->split >= 1 && a->split <= 8 &&
         a->rows >= 1 && a->rows % 8 == 0 &&
         (long)a->split * a->rows >= a->k &&
         (long)(a->split - 1) * a->rows < a->k && a->chunk_rows >= 1 &&
         a->chunk_rows <= 256 &&
         (a->w_route != kBulk ||
          (a->chunk_rows % 16 == 0 && a->rows % 16 == 0));
}

// Launches the instantiation, or (with `blocks`) lets it use the card's
// shared memory and asks how many of its CTAs one SM holds and, for a
// cluster launch, how many clusters the card holds at once.
template <typename T, int V>
int run(const LifArgs* a, int* blocks, int* clusters, cudaStream_t stream) {
  const int e = sizeof(T);
  if ((int)lif_layout(*a, e).total != a->smem)
    return (int)cudaErrorInvalidValue;
  auto kernel = lif_forward_kernel<T, V>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((a->m + a->cols - 1) / a->cols),
                     (unsigned)a->split);
  cfg.blockDim = dim3((unsigned)a->threads);
  cfg.dynamicSmemBytes = (size_t)a->smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (a->split > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = (unsigned)a->split;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaError_t err;
  if (blocks != nullptr) {
    int device = 0, optin = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             blocks, kernel, a->threads, (size_t)a->smem)) != cudaSuccess)
      return (int)err;
    *clusters = 0;
    if (a->split > 1)
      return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
    return (int)cudaSuccess;
  }
  LifParams prm;
  prm.a = *a;
  if (a->w_route == kTma &&
      !encode(&prm.w_map, a->w, a->k, a->m, e, a->cols, a->chunk_rows))
    return (int)cudaErrorInvalidValue;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, prm)) != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int PV>
int run_vec(const LifArgs* a, int* blocks, int* clusters,
            cudaStream_t stream) {
  if (!valid(a, PV, (int)sizeof(T))) return (int)cudaErrorInvalidValue;
  return a->vec == 1 ? run<T, 1>(a, blocks, clusters, stream)
                     : run<T, PV>(a, blocks, clusters, stream);
}

// kind 0: float32, 1: bfloat16.
int dispatch(const LifArgs* a, int kind, int* blocks, int* clusters,
             cudaStream_t stream) {
  switch (kind) {
    case 0: return run_vec<float, 4>(a, blocks, clusters, stream);
    case 1: return run_vec<__nv_bfloat16, 8>(a, blocks, clusters, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int lif_forward_f32(const LifArgs* a, cudaStream_t stream) {
  return dispatch(a, 0, nullptr, nullptr, stream);
}

extern "C" int lif_forward_bf16(const LifArgs* a, cudaStream_t stream) {
  return dispatch(a, 1, nullptr, nullptr, stream);
}

// The instantiation `a` and kind (as `dispatch`) select may use the card's
// shared memory; CTAs of it one SM holds, and clusters the card holds (0
// without a cluster).
extern "C" int lif_forward_occupancy(const LifArgs* a, int kind, int* blocks,
                                     int* clusters) {
  return dispatch(a, kind, blocks, clusters, nullptr);
}
