// Primitive-rate probes for Hopper (sm_90a): P1-P4.
//
// Replace the four Mosaic probes of tools/probe_pallas_prims.py (`probe_dyn`
// A and B, `probe_dma` C, `probe_lane_gather` D), which measure the rates
// that bound any per-edge gather kernel on the TPU. Each kernel here
// computes what its Mosaic counterpart computes, in this card's terms, so
// that the gather kernels (K1, K2, K7, K8) can be held against a MEASURED
// ceiling of the primitive they are built from, not only against "every
// byte once":
//
//   P1 dyn_load   N index-dependent loads of an (8, 128) f32 row-block from
//                 a table in SHARED memory, summed. (Mosaic A: the table is
//                 in VMEM.) A block of 256 threads is one stream; thread t
//                 owns float4 t of the 4 KB tile, so one op is 256
//                 conflict-free 16-byte shared loads and 4 adds a thread
//                 (summed in rounds of 256 ops, then over the rounds).
//   P2 dyn_rmw    the same as a read-modify-write: scratch[r] += 1 on a
//                 shared-memory scratch of the table's size; the whole
//                 scratch is written out (row-block b holds the count of b).
//                 (Mosaic B.)
//   P3 row_copy   N per-row 512-byte asynchronous copies from device memory
//                 into a shared-memory ring of depth 16, issue and wait as
//                 the Mosaic loop does: wait for the slot's previous copy,
//                 then issue into it. (Mosaic C: per-row DMA HBM -> VMEM.) A
//                 warp is one stream with its own ring; a row is 32
//                 `cp.async` pieces of 16 bytes, one per lane, committed as
//                 one group, so "wait for slot i % 16" is
//                 `cp.async.wait_group 15`. The ring's final rows are
//                 written out. With 256-byte rows (the bf16 F=128 row the
//                 gather kernels read) a half-warp is one stream, so a warp
//                 keeps the same bytes in flight as at 512: whether the rows
//                 or the bytes a second bind shows in the rates.
//   P4 lane_gather N gathers along the 128 columns of an (8, 128) f32 tile
//                 held in REGISTERS, out[r, c] = tile[r, ids[c]], summed.
//                 (Mosaic D: lane dynamic_gather on a vreg tile.) A warp is
//                 one stream; lane l holds columns l, l+32, l+64, l+96 of
//                 every row, so a gathered element is `__shfl_sync` with a
//                 per-lane source lane (ids % 32) from each of the 4
//                 registers that may hold it, and a select on ids / 32:
//                 128 indexed shuffles a lane per op.
//
// What bounds them: P1/P2 shared-memory bandwidth (4 KB, or 4 KB read and
// 4 KB written, per op and block); P3 the latency of a 256- or 512-byte row from
// device memory (or L2) over the 16 copies a stream keeps in flight; P4 the
// shuffle issue rate. They are probes: their times ARE the result, and
// nothing in the training path calls them. The wrappers
// (dorylus_tpu_torch/tools/probe_prims.py) time one block (the per-SM
// rate, the counterpart of one Mosaic grid step) and a grid that fills the
// card.
//
// Indices are read ahead of the chain (P1/P2: staged through shared memory
// 256 at a time; P3: one coalesced load per 32 ops, prefetched one round
// ahead; P4: the 64 id rows live in shared memory), so the measured chain is
// the primitive, not the index fetch.

#include "gather.cuh"

namespace {

using dorylus::kFullMask;

constexpr int kTileVec = 256;     // float4s of one (8, 128) f32 row-block
constexpr int kTileThreads = 256; // P1/P2: one float4 of the tile per thread
constexpr int kIdxChunk = 256;    // P1/P2: indices staged per round
constexpr int kWarps = 8;         // P3/P4: streams (warps) per block
constexpr int kDepth = 16;        // P3: ring depth, as the Mosaic probe's
constexpr int kIdRows = 64;       // P4: id rows, cycled
constexpr int kCols = 128;

__global__ void __launch_bounds__(kTileThreads)
dyn_load_kernel(const float4* __restrict__ tab, int tab_blocks,
                const int32_t* __restrict__ idx, int n_ops,
                float4* __restrict__ out) {
  extern __shared__ float4 smem[];  // the table, then kIdxChunk indices
  int32_t* sidx = reinterpret_cast<int32_t*>(smem + (size_t)tab_blocks * kTileVec);
  const int t = threadIdx.x;
  for (int i = t; i < tab_blocks * kTileVec; i += kTileThreads) smem[i] = tab[i];
  const int32_t* mine = idx + (size_t)blockIdx.x * n_ops;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < n_ops; i0 += kIdxChunk) {
    __syncthreads();  // the table is staged; the last round's indices are used
    if (i0 + t < n_ops) sidx[t] = mine[i0 + t];
    __syncthreads();
    const int m = min(kIdxChunk, n_ops - i0);
    // A round's blocks are summed apart and then added to the total: one
    // serial f32 chain over 100,000 blocks drifts from the true sum by more
    // than 1e-4 of it, a chain of rounds does not.
    float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const float4 v = smem[sidx[j] * kTileVec + t];
      part.x += v.x;
      part.y += v.y;
      part.z += v.z;
      part.w += v.w;
    }
    acc.x += part.x;
    acc.y += part.y;
    acc.z += part.z;
    acc.w += part.w;
  }
  out[(size_t)blockIdx.x * kTileVec + t] = acc;
}

__global__ void __launch_bounds__(kTileThreads)
dyn_rmw_kernel(int tab_blocks, const int32_t* __restrict__ idx, int n_ops,
               float4* __restrict__ out) {
  extern __shared__ float4 smem[];  // the scratch, then kIdxChunk indices
  int32_t* sidx = reinterpret_cast<int32_t*>(smem + (size_t)tab_blocks * kTileVec);
  const int t = threadIdx.x;
  // Thread t touches float4 t of every row-block and nothing else, so its
  // own program order is all the ordering the scratch needs.
  for (int b = 0; b < tab_blocks; ++b) smem[b * kTileVec + t] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int32_t* mine = idx + (size_t)blockIdx.x * n_ops;
  for (int i0 = 0; i0 < n_ops; i0 += kIdxChunk) {
    __syncthreads();
    if (i0 + t < n_ops) sidx[t] = mine[i0 + t];
    __syncthreads();
    const int m = min(kIdxChunk, n_ops - i0);
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      float4* p = smem + sidx[j] * kTileVec + t;
      float4 v = *p;
      v.x += 1.f;
      v.y += 1.f;
      v.z += 1.f;
      v.w += 1.f;
      *p = v;
    }
  }
  float4* o = out + (size_t)blockIdx.x * tab_blocks * kTileVec;
  for (int b = 0; b < tab_blocks; ++b) o[b * kTileVec + t] = smem[b * kTileVec + t];
}

// lanes: 32 (512-byte rows, the Mosaic probe's 128 f32) or 16 (256-byte
// rows). A row is lanes pieces of 16 bytes, one per lane, and those lanes are
// one stream with a ring of its own: a warp holds 32 / lanes streams, so the
// bytes a warp keeps in flight are the same for both widths and only the row
// count differs.
__global__ void __launch_bounds__(32 * kWarps)
row_copy_kernel(const float* __restrict__ tab, const int32_t* __restrict__ idx,
                int n_streams, int n_ops, int lanes, float* __restrict__ out) {
  const int cols = 4 * lanes;  // floats of a row
  extern __shared__ float4 smem[];  // kWarps * 32 / lanes rings of kDepth rows
  const int lane = threadIdx.x & 31;
  const int gl = lane % lanes;
  const int s = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / lanes) + lane / lanes;
  if ((s - s % (32 / lanes)) >= n_streams) return;  // uniform across the warp
  // a lane of a stream past n_streams joins the shuffles and copies nothing
  const bool live = s < n_streams;
  float* ring = reinterpret_cast<float*>(smem) + (threadIdx.x / lanes) * (kDepth * cols);
  const int32_t* mine = idx + (size_t)(live ? s : 0) * n_ops;
  int next = live && gl < n_ops ? mine[gl] : 0;
  for (int i0 = 0; i0 < n_ops; i0 += lanes) {
    const int cur = next;
    if (live && i0 + lanes + gl < n_ops) next = mine[i0 + lanes + gl];
    const int m = min(lanes, n_ops - i0);
    for (int j = 0; j < m; ++j) {
      const int i = i0 + j;
      const int r = __shfl_sync(kFullMask, cur, j, lanes);
      if (i >= kDepth) {
        // this lane's piece of the slot's previous row has landed
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
      }
      if (live) {
        const float* src = tab + (size_t)r * cols + 4 * gl;
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(ring + (i % kDepth) * cols + 4 * gl));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
                     : "memory");
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  if (!live) return;
  // each lane reads back the pieces it copied
  float4* o = reinterpret_cast<float4*>(out + (size_t)s * (kDepth * cols));
  const float4* r4 = reinterpret_cast<const float4*>(ring);
  for (int slot = 0; slot < kDepth; ++slot) o[slot * lanes + gl] = r4[slot * lanes + gl];
}

__global__ void __launch_bounds__(32 * kWarps)
lane_gather_kernel(const float* __restrict__ tab, const int32_t* __restrict__ ids,
                   int n_streams, int n_ops, float* __restrict__ out) {
  __shared__ int32_t sids[kIdRows * kCols];
  for (int i = threadIdx.x; i < kIdRows * kCols; i += 32 * kWarps) sids[i] = ids[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_streams) return;
  const float* tile = tab + (size_t)s * (8 * kCols);
  float reg[8][4], acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      reg[r][k] = tile[r * kCols + 32 * k + lane];
      acc[r][k] = 0.f;
    }
  }
  for (int i = 0; i < n_ops; ++i) {
    const int32_t* row = sids + (i & (kIdRows - 1)) * kCols;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int id = row[32 * k + lane];  // source column of out[:, 32k + lane]
      const int src_lane = id & 31;
      const int src_reg = id >> 5;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float v0 = __shfl_sync(kFullMask, reg[r][0], src_lane);
        const float v1 = __shfl_sync(kFullMask, reg[r][1], src_lane);
        const float v2 = __shfl_sync(kFullMask, reg[r][2], src_lane);
        const float v3 = __shfl_sync(kFullMask, reg[r][3], src_lane);
        acc[r][k] += src_reg == 0 ? v0 : src_reg == 1 ? v1 : src_reg == 2 ? v2 : v3;
      }
    }
  }
  float* o = out + (size_t)s * (8 * kCols);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[r * kCols + 32 * k + lane] = acc[r][k];
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

size_t tile_table_bytes(int tab_blocks) {
  return (size_t)tab_blocks * kTileVec * sizeof(float4) + kIdxChunk * sizeof(int32_t);
}

}  // namespace

extern "C" {

// The most shared memory a block may ask for on `device` (bytes), or the
// negated CUDA error code.
int probe_max_shared(int device) {
  int bytes = 0;
  cudaError_t err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// Every launcher: returns the CUDA error code of the launch (0 =
// cudaSuccess), launches on `stream`, does not synchronise, allocates
// nothing. One stream of ops per block (P1, P2) or per warp (P3, P4).

// P1. tab: (tab_blocks * 8, 128) f32; idx: (n_streams, n_ops) int32 in
// [0, tab_blocks); out: (n_streams, 8, 128) f32.
int probe_dyn_load(int device, const void* tab, int tab_blocks, const void* idx,
                   int n_streams, int n_ops, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_streams <= 0) return 0;
  const size_t bytes = tile_table_bytes(tab_blocks);
  err = allow_shared(dyn_load_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dyn_load_kernel<<<n_streams, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(tab), tab_blocks, static_cast<const int32_t*>(idx), n_ops,
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// P2. idx as P1; out: (n_streams, tab_blocks, 8, 128) f32, the scratch.
int probe_dyn_rmw(int device, int tab_blocks, const void* idx, int n_streams, int n_ops,
                  void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_streams <= 0) return 0;
  const size_t bytes = tile_table_bytes(tab_blocks);
  err = allow_shared(dyn_rmw_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dyn_rmw_kernel<<<n_streams, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      tab_blocks, static_cast<const int32_t*>(idx), n_ops, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// P3. tab: (rows, row_bytes / 4) f32 in device memory, row_bytes 512 or
// 256; idx: (n_streams, n_ops) int32 in [0, rows), n_ops >= 16; out:
// (n_streams, 16, row_bytes / 4) f32, each stream's ring (slot i % 16 holds
// the row of its last op i).
int probe_row_copy(int device, const void* tab, int row_bytes, const void* idx, int n_streams,
                   int n_ops, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_streams <= 0) return 0;
  if (n_ops < kDepth || (row_bytes != 512 && row_bytes != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // every warp holds 512 bytes of each of its kDepth ring slots
  const size_t bytes = (size_t)kWarps * kDepth * 512;
  const int per_block = kWarps * (512 / row_bytes);
  const int blocks = (n_streams + per_block - 1) / per_block;
  err = allow_shared(row_copy_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_copy_kernel<<<blocks, 32 * kWarps, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int32_t*>(idx), n_streams, n_ops,
      row_bytes / 16, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// P4. tab: (n_streams, 8, 128) f32; ids: (64, 128) int32 in [0, 128), row
// i % 64 serves op i; out: (n_streams, 8, 128) f32.
int probe_lane_gather(int device, const void* tab, const void* ids, int n_streams, int n_ops,
                      void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_streams <= 0) return 0;
  const int blocks = (n_streams + kWarps - 1) / kWarps;
  lane_gather_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int32_t*>(ids), n_streams, n_ops,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
