// Fleet dense-stack forward for Hopper (sm_90a): K1 of the port, and K2,
// the same forward with a per-row MSE epilogue.
//
// Replaces gordo_tpu/ops/pallas_dense.py::fleet_feedforward_pallas, the
// TPU kernel that walks a feedforward autoencoder's whole layer stack for
// one fleet member per grid step with every activation kept in VMEM.
//
// What it computes: out[m, r, :] = head(act_L(...act_0(x W_0 + b_0)...)),
// for member row n = indices[m] of the resident bucket, with the optional
// ingest prologue x = X[m, r, :] * scale[n, :] + offset[n, :] applied in
// float32 to the loaded tile. Weights are W_l[N, d_in, d_out] and biases
// b_l[N, d_out], float32, row-major and contiguous; X is [M, B, F] and
// out is [M, B, F_out].
//
// What bounds it on an H100 SXM (67 TFLOP/s f32 without tensor cores,
// 3.35 TB/s; the ridge is 20 flops a byte):
//   - feedforward_hourglass(20) (20-17-13-10-10-13-17-20): 2,964 flops a
//     row against 160 bytes of input and output plus ~6 KB of weights a
//     member, ~18 flops a byte: bound by bytes. At M=1000, B=1008 the
//     ~167 MB take ~50 us; the 3.0 GFLOP would take ~45 us.
//   - feedforward_model(20) defaults (20-256-128-64-64-128-256-20):
//     192,512 flops a row, ~1,000 flops a byte: bound by the f32 rate.
//
// How it tiles. Widths and activation codes are kernel arguments, so one
// build serves every spec. A block reads its member index and the params
// at that index itself, so no gathered copy of the bucket is ever made.
// Two kernels, chosen by the spec's widest layer:
//
// Narrow specs (every width <= kNarrowWidth = 32; the production
// hourglass is 20 wide): fleet_dense_narrow_kernel<S>. A thread walks a
// row through every layer with the activations in registers, reading the
// member's weights from shared memory (float4 loads, the same address
// across the warp: a broadcast). What bounds it:
//   - Not the bytes. Exact f32 FMAs and exact tanhf on the CUDA cores
//     (1,708 FMAs and 80 tanhf of two MUFU ops each a row of
//     hourglass(20)) cost ~4,000 warp instructions per 32 rows, ~0.13 ms
//     at 1000 x 1008 on 528 schedulers at 1.98 GHz even at one
//     instruction a clock, against the ~0.05 ms byte bound; only tensor
//     cores (3xTF32 mma for f32 accuracy) reach the bytes. Measured, it
//     issues at about half that rate: see PERF.md.
//   - So the kernel must keep the schedulers issuing, with no serial
//     prologue, no block idle on its own loads and no wasted FMAs. What
//     each choice does about it:
//   - Persistent blocks. The grid is the SM count times the blocks an SM
//     holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor), at most one
//     block per tile. Block b takes the b-th contiguous run of the
//     flattened (batch row m, row tile) sequence, so the tiles split
//     evenly (within one) over the blocks whatever M and B are: at 1000
//     x 1008 each of 528 blocks walks 15-16 tiles of 2-3 members. The
//     ragged last tile of each member is masked, not padded.
//   - One staging group per member change. A block stages member n's
//     params (every layer's W, zero-padded to [d_in][ldw] with ldw =
//     d_out rounded up to 4, its b as row d_in, and the ingest scale and
//     offset) with one 4-byte cp.async a float, all issued together, and
//     waits once; a warp a row, a lane a column, the rows of all layers
//     dealt round-robin to the warps. The offsets (w_off, ldw, the first
//     warp of each layer) are worked out on the host: no division on the
//     device. It re-stages only when indices[m] changes, so repeated
//     members in neighbouring batch rows share one staging.
//   - Double-buffered row tiles. Tile t + 1's rows are in flight
//     (cp.async, 16 bytes where the rows are 16-byte aligned) while tile
//     t is computed, and the first tile's rows are issued before the
//     member index is read; a new member's params are issued as soon as
//     the last tile of the old one is computed, so they fly under its
//     output stores. The output leaves from shared memory in coalesced
//     16-byte stores, which the thread does not wait on. Two barriers a
//     tile.
//   - Many FMAs in flight, none wasted. A layer is k-outer: per k the
//     float4 loads of weight row k feed 4 FMAs each on independent sums
//     (4 * ldw / 4 of them), so a thread keeps up to 32 sums going
//     instead of one chain of d_in. k runs over the real d_in; only the
//     columns are padded to 4: 1,708 FMAs a row at hourglass(20), not
//     1,968. The column groups ldw / 4 are a template argument chosen by
//     a switch a layer, so every loop is unrolled with static register
//     indices and the layer works in place on the row's registers. The
//     activation goes four elements to a branch, so they interleave.
//   - Few rows: S lanes a row. When M x B rows make fewer tiles than the
//     card has SMs (one served machine), a launch waits on one row's
//     chain of layers; then S = 4 (or 2) lanes share a row, each summing
//     and activating a quarter of the column groups, and swap them by
//     __shfl_sync after each layer, with tiles of 128 / S rows.
//     Otherwise S = 1: a split costs shuffles and padding that lose
//     wherever the card is full.

// Wider specs (up to kMaxWidth = 512): fleet_dense_wide_kernel<TB>, a
// SIMT matrix product in the style of an SGEMM, one layer after another.
//   - TB = 64 rows a block (32 above 256 wide), 256 threads (512 above
//     128 wide, where the layers keep 16 warps busy). The tile's
//     activations live in two shared-memory buffers, transposed
//     ([width][TB + 4]); layers ping-pong between them and only the
//     final layer is written out.
//   - A layer's weights do not fit at once (feedforward_model's 256x128
//     is 128 KB beside 136 KB of activations), so they stream through
//     two 16-row chunk buffers with cp.async: chunk c + 1 is in flight
//     while chunk c is multiplied.
//   - Each thread holds an 8-row x 4-column tile of the output in 32
//     registers: per k it reads two float4 of activations (a broadcast
//     within a warp) and 4 weights (consecutive across the warp, so no
//     bank conflicts) for 32 FMAs.
//   - Bias, activation and softmax (a reduction across a row) are
//     separate passes over the finished layer in shared memory.
//
// Both kernels sum in plain f32 FMAs, k in order, and add the bias after
// the sum, as the plain version's bmm + b does. No TF32, no tensor cores.
//
// K2, the fleet anomaly scores (fleet_dense_forward with y and mse), replaces
// gordo_tpu/ops/pallas_dense.py::fleet_anomaly_scores_pallas: K1, then
// the per-row mean squared error against targets y[M, B, F_y],
//   mse[m, r] = (1/w) * sum_{j<w} (out[m, r, j] - y[m, r, j])^2,
// w = min(F_out, F_y), in f32, divided by w (as numpy's f32 mean), NaN
// propagating. It is an epilogue of both kernels above, so the
// reconstruction is never read back from device memory; it adds 4 bytes
// a row to K1's traffic (and y's bytes when y is not X).
//   - Narrow kernel: the thread that owns a row holds its outputs in
//     registers and sums its own squared differences; no reduction across
//     threads. When y is X itself (the store's case: the error against the
//     raw rows), y comes from the raw tile still in shared memory (the
//     ingest prologue only read it; the buffer is refilled only after the
//     tile's last barrier), so y costs no second read. Otherwise each
//     thread reads its row of y from global memory.
//   - Wide kernel: the final store walks one row a warp, lanes striding
//     the row's columns; each lane sums its squares, a warp shuffle adds
//     them, and lane 0 writes the row's mse.
// Padded weight columns (narrow: widths rounded up to 4; wide: chunks)
// never enter the sum: it runs over the real columns j < w only.
//
// Neither kernel uses fast math, *.approx intrinsics or TF32.
//
// Builds for measurement only (chip_smoke.py, scripts/narrow_ablation.py):
// -DFLEET_DENSE_WIDE_ONLY sends narrow specs to the wide kernel;
// -DFLEET_DENSE_NO_SPLIT never shares a row among lanes; and
// -DFLEET_DENSE_SKIP_FMAS / -DFLEET_DENSE_SKIP_ACTIVATIONS leave the
// narrow kernel's layer sums or activations out, computing wrong answers
// on purpose, so that the time of each part shows apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 32;
constexpr int kMaxWidth = 512;
constexpr int kNarrowWidth = 32;
constexpr int kNarrowThreads = 128;  // threads a block of the narrow kernel
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kWideKC = 16;  // weight rows a chunk

// Must match gordo_tpu_torch/ops/activations.py ACTIVATION_CODES.
enum Act : int {
  kLinear = 0,
  kTanh,
  kRelu,
  kSigmoid,
  kHardSigmoid,
  kElu,
  kSelu,
  kSoftplus,
  kSoftsign,
  kSwish,
  kSilu,
  kGelu,
  kLeakyRelu,
  kRelu6,
  kExponential,
  kSoftmax,
  kNumActs
};

// Argument-check failures, returned as negative codes (CUDA errors are
// returned as their positive cudaError_t values).
enum Status : int {
  kBadShape = -1,
  kTooManyLayers = -2,
  kTooWide = -3,
  kBadActivation = -4,
  kBadPointer = -5,
};

struct Layer {
  const float* W;  // [N, d_in, d_out]
  const float* b;  // [N, d_out]
  int d_in;
  int d_out;
  int act;
  // narrow kernel, worked out on the host:
  int ldw;    // d_out rounded up to 4, the staged row length
  int w_off;  // offset of the staged W, in floats; b is its row d_in
  int warp0;  // the warp that stages row 0 (the rows of all layers are
              // dealt round-robin to the warps)
};

struct Args {
  const float* X;       // [M, B, F]
  float* out;           // [M, B, F_out]
  const int* indices;   // [M], rows of the bucket
  const float* scale;   // [N, F] or null
  const float* offset;  // [N, F] or null
  const float* y;       // [M, B, F_y] or null (K1 alone); may be X itself
  float* mse;           // [M, B] or null
  int B, F, F_out, n_layers;
  int F_y;
  int w;                // columns in the MSE: min(F_out, F_y)
  int tiles;            // row tiles per member
  long long n_tiles;    // narrow kernel: M * tiles
  int ingest_off;       // narrow kernel: offset of the staged scale, offset
  int ingest_warp;      // narrow kernel: the warp that stages scale
  int stage_floats;     // narrow kernel: floats of the staged params
  int x_floats;         // narrow kernel: floats of one row-tile buffer
  int act_floats;       // wide kernel: floats in one activation buffer
  int w_floats;         // wide kernel: floats in one weight chunk
  Layer layers[kMaxLayers];
};

__device__ __forceinline__ float clamp_relu6(float x) {
  // comparisons (not fminf/fmaxf) so a NaN passes through, like jnp
  return x < 0.f ? 0.f : (x > 6.f ? 6.f : x);
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kTanh:
      return tanhf(x);
    case kRelu:
      return x < 0.f ? 0.f : x;
    case kSigmoid:
      return 1.f / (1.f + expf(-x));
    case kHardSigmoid:
      return clamp_relu6(x + 3.f) / 6.f;
    case kElu:
      return x > 0.f ? x : expm1f(x);
    case kSelu:
      return 1.0507009873554805f * (x > 0.f ? x : 1.6732632423543772f * expm1f(x));
    case kSoftplus:  // logaddexp(x, 0)
      return (x > 0.f ? x : 0.f) + log1pf(expf(-fabsf(x)));
    case kSoftsign:
      return x / (fabsf(x) + 1.f);
    case kSwish:
    case kSilu:
      return x * (1.f / (1.f + expf(-x)));
    case kGelu:  // tanh approximation, as jax.nn.gelu's default
      return x * (0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x)))));
    case kLeakyRelu:
      return x >= 0.f ? x : 0.01f * x;
    case kRelu6:
      return clamp_relu6(x);
    case kExponential:
      return expf(x);
    default:  // kLinear; kSoftmax is a row reduction, done by the caller
      return x;
  }
}

template <int A>
struct ActCode {
  static constexpr int value = A;
};

// Calls fn(ActCode<act>{}), so that a loop inside fn sees the activation
// as a constant and holds no branch on it. Linear and softmax are left to
// the caller.
template <typename Fn>
__device__ __forceinline__ void with_activation(int act, Fn fn) {
  switch (act) {
    case kTanh: fn(ActCode<kTanh>{}); break;
    case kRelu: fn(ActCode<kRelu>{}); break;
    case kSigmoid: fn(ActCode<kSigmoid>{}); break;
    case kHardSigmoid: fn(ActCode<kHardSigmoid>{}); break;
    case kElu: fn(ActCode<kElu>{}); break;
    case kSelu: fn(ActCode<kSelu>{}); break;
    case kSoftplus: fn(ActCode<kSoftplus>{}); break;
    case kSoftsign: fn(ActCode<kSoftsign>{}); break;
    case kSwish:
    case kSilu: fn(ActCode<kSilu>{}); break;
    case kGelu: fn(ActCode<kGelu>{}); break;
    case kLeakyRelu: fn(ActCode<kLeakyRelu>{}); break;
    case kRelu6: fn(ActCode<kRelu6>{}); break;
    case kExponential: fn(ActCode<kExponential>{}); break;
    default: break;
  }
}

// Softmax over v[0:width), in registers.
__device__ __forceinline__ void softmax_row(float (&v)[kNarrowWidth], int width) {
  float mx = v[0];
#pragma unroll
  for (int j = 1; j < kNarrowWidth; ++j) {
    if (j >= width) break;
    mx = v[j] > mx ? v[j] : mx;
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kNarrowWidth; ++j) {
    if (j >= width) break;
    v[j] = expf(v[j] - mx);
    sum += v[j];
  }
#pragma unroll
  for (int j = 0; j < kNarrowWidth; ++j) {
    if (j >= width) break;
    v[j] = v[j] / sum;
  }
}

// One layer's sums for the column groups a lane owns, with S lanes to a
// row: lane s of a row owns groups s, s + S, ... of the layer's G groups
// of 4 columns (with S = 1 a lane owns all of them), and
// acc[q] = (in W + b)[4g:4g + 4] for its q-th group g. k runs over the
// real d_in, in order; per k the lane's float4 weight loads feed 4 FMAs
// each, on independent sums, so a thread keeps many FMAs in flight
// rather than one chain of d_in. A lane past the last group repeats the
// last one (its sums are never read). Staged W is [d_in][ldw], its
// columns past d_out zero, and b is its row d_in.
template <int G, int S>
__device__ __forceinline__ void narrow_columns(const float (&in)[kNarrowWidth],
                                               float4 (&acc)[kNarrowWidth / 4 / S],
                                               const float* w, int d_in, int ldw, int s) {
  constexpr int Q = (G + S - 1) / S;
  int col[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    col[q] = 4 * min(s + S * q, G - 1);
    acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kNarrowWidth; ++k) {
    if (k >= d_in) break;
#ifdef FLEET_DENSE_SKIP_FMAS
    break;
#endif
    float4 wv[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) wv[q] = *reinterpret_cast<const float4*>(w + k * ldw + col[q]);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      acc[q].x = fmaf(in[k], wv[q].x, acc[q].x);
      acc[q].y = fmaf(in[k], wv[q].y, acc[q].y);
      acc[q].z = fmaf(in[k], wv[q].z, acc[q].z);
      acc[q].w = fmaf(in[k], wv[q].w, acc[q].w);
    }
  }
  const float* bias = w + d_in * ldw;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float4 bv = *reinterpret_cast<const float4*>(bias + col[q]);
    acc[q].x += bv.x;
    acc[q].y += bv.y;
    acc[q].z += bv.z;
    acc[q].w += bv.w;
  }
}

// One layer of one row, in place in registers: h = act(h W + b), every
// lane of the row ending with the whole of h. The column groups G = ldw /
// 4 are a template argument, so every loop is unrolled with static
// register indices. Each lane applies the activation to its own groups,
// four elements to a branch so that they interleave (the columns past
// d_out are activated too, and never read); with S > 1 the lanes then
// swap their groups by __shfl_sync. Softmax, a reduction over the row,
// runs after the swap.
template <int S>
__device__ __forceinline__ void narrow_layer(float (&h)[kNarrowWidth], const float* smem,
                                             const Layer& L, int s) {
  constexpr int QMAX = kNarrowWidth / 4 / S;
  float4 acc[QMAX];
  const float* w = smem + L.w_off;
  const int groups = L.ldw >> 2;
  switch (groups) {
    case 1: narrow_columns<1, S>(h, acc, w, L.d_in, L.ldw, s); break;
    case 2: narrow_columns<2, S>(h, acc, w, L.d_in, L.ldw, s); break;
    case 3: narrow_columns<3, S>(h, acc, w, L.d_in, L.ldw, s); break;
    case 4: narrow_columns<4, S>(h, acc, w, L.d_in, L.ldw, s); break;
    case 5: narrow_columns<5, S>(h, acc, w, L.d_in, L.ldw, s); break;
    case 6: narrow_columns<6, S>(h, acc, w, L.d_in, L.ldw, s); break;
    case 7: narrow_columns<7, S>(h, acc, w, L.d_in, L.ldw, s); break;
    default: narrow_columns<8, S>(h, acc, w, L.d_in, L.ldw, s); break;
  }
#ifdef FLEET_DENSE_SKIP_ACTIVATIONS
  const int act = kLinear;
#else
  const int act = L.act;
#endif
  if (act != kSoftmax) {
    with_activation(act, [&](auto code) {
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        if (q * S >= groups) break;
        acc[q].x = activate(acc[q].x, decltype(code)::value);
        acc[q].y = activate(acc[q].y, decltype(code)::value);
        acc[q].z = activate(acc[q].z, decltype(code)::value);
        acc[q].w = activate(acc[q].w, decltype(code)::value);
      }
    });
  }
#pragma unroll
  for (int g = 0; g < kNarrowWidth / 4; ++g) {
    if (g >= groups) break;
    float4 v = acc[g / S];
    if (S > 1) {
      v.x = __shfl_sync(0xffffffffu, v.x, g % S, S);
      v.y = __shfl_sync(0xffffffffu, v.y, g % S, S);
      v.z = __shfl_sync(0xffffffffu, v.z, g % S, S);
      v.w = __shfl_sync(0xffffffffu, v.w, g % S, S);
    }
    h[4 * g + 0] = v.x;
    h[4 * g + 1] = v.y;
    h[4 * g + 2] = v.z;
    h[4 * g + 3] = v.w;
  }
  if (act == kSoftmax) softmax_row(h, L.d_out);
}

// cp.async (sm_80 and later): a 4-byte global-to-shared copy that does
// not stall the thread; with valid false it writes a zero and reads
// nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// The same for 16 bytes; both ends 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Member n's params into the staging area, every copy in flight together
// (the caller commits the group): each layer's W rows and then b as its
// row d_in, zeros past d_out, and the ingest scale and offset. A warp a
// row, a lane a column; row i of a layer goes to warp (warp0 + i) % 4.
__device__ __forceinline__ void stage_member(float* smem, const Args& a, int n) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int l = 0; l < a.n_layers; ++l) {
    const Layer& L = a.layers[l];
    if (lane >= L.ldw) continue;
    const bool valid = lane < L.d_out;
    const int col = valid ? lane : 0;
    const float* W = L.W + (size_t)n * L.d_in * L.d_out + col;
    const float* b = L.b + (size_t)n * L.d_out + col;
    float* dst = smem + L.w_off + lane;
    for (int k = (warp - L.warp0) & (kNarrowWarps - 1); k <= L.d_in; k += kNarrowWarps) {
      cp_async4(dst + k * L.ldw, k < L.d_in ? W + k * L.d_out : b, valid);
    }
  }
  if (a.scale && lane < a.F) {
    if (warp == a.ingest_warp) {
      cp_async4(smem + a.ingest_off + lane, a.scale + (size_t)n * a.F + lane, true);
    }
    if (warp == ((a.ingest_warp + 1) & (kNarrowWarps - 1))) {
      cp_async4(smem + a.ingest_off + kNarrowWidth + lane, a.offset + (size_t)n * a.F + lane, true);
    }
  }
}

// n floats from global src to shared dst (16-byte aligned) with cp.async,
// 16 bytes a copy where src is 16-byte aligned too.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = 4 * threadIdx.x; i + 4 <= n; i += 4 * kNarrowThreads) cp_async16(dst + i, src + i);
    i0 = n & ~3;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kNarrowThreads) cp_async4(dst + i, src + i, true);
}

// n floats from shared src (16-byte aligned) to global dst, 16 bytes a
// store where dst is 16-byte aligned too.
__device__ __forceinline__ void store_rows(float* dst, const float* src, int n) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = 4 * threadIdx.x; i + 4 <= n; i += 4 * kNarrowThreads) {
      *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(src + i);
    }
    i0 = n & ~3;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kNarrowThreads) dst[i] = src[i];
}

// The tile's rows through every layer, S lanes to a row: lane s of row
// threadIdx.x / S (raw values in xtile, `rows` of them valid). The
// reconstruction goes to the output tile in shared memory and, for K2,
// each row's mse straight to device memory, both from lane 0 of the
// row. A lane past the ragged end repeats the last row (the lanes of a
// warp all take part in every __shfl_sync) and stores nothing.
template <int S>
__device__ __forceinline__ void narrow_rows(const Args& a, const float* smem, const float* xtile,
                                            float* otile, int m, int row0, int rows) {
  const int r = min((int)threadIdx.x / S, rows - 1);
  const int s = threadIdx.x % S;
  const float* x = xtile + r * a.F;
  float h[kNarrowWidth];
#pragma unroll
  for (int k = 0; k < kNarrowWidth; ++k) h[k] = 0.f;
  const float* sc = smem + a.ingest_off;
  const float* of = sc + kNarrowWidth;
#pragma unroll
  for (int k = 0; k < kNarrowWidth; ++k) {
    if (k >= a.F) break;
    // multiply then add, each rounded, as the plain version does
    h[k] = a.scale ? __fadd_rn(__fmul_rn(x[k], sc[k]), of[k]) : x[k];
  }

  for (int l = 0; l < a.n_layers; ++l) narrow_layer<S>(h, smem, a.layers[l], s);

  if (s != 0 || (int)threadIdx.x / S >= rows) return;
  if (a.mse) {
    // K2's epilogue: y = X is the raw row, still in shared memory
    const float* y = a.y == a.X ? x : a.y + ((size_t)m * a.B + row0 + r) * a.F_y;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kNarrowWidth; ++j) {
      if (j >= a.w) break;
      const float d = h[j] - y[j];
      sum = fmaf(d, d, sum);
    }
    a.mse[(size_t)m * a.B + row0 + r] = sum / (float)a.w;
  }
  float* o = otile + r * a.F_out;
#pragma unroll
  for (int j = 0; j < kNarrowWidth; ++j) {
    if (j >= a.F_out) break;
    o[j] = h[j];
  }
}

// Shared memory: the staged params (a.stage_floats), two row-tile
// buffers of kNarrowThreads / S rows x F (a.x_floats each), one output
// tile of kNarrowThreads / S rows x F_out.
template <int S>
__global__ void __launch_bounds__(kNarrowThreads)
    fleet_dense_narrow_kernel(const __grid_constant__ Args a) {
  constexpr int TR = kNarrowThreads / S;  // rows a tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xbuf = smem + a.stage_floats;
  float* obuf = xbuf + 2 * a.x_floats;

  // this block's run of the flattened (batch row, tile) sequence
  long long t = (long long)blockIdx.x * a.n_tiles / gridDim.x;
  const long long t_end = (long long)(blockIdx.x + 1) * a.n_tiles / gridDim.x;
  if (t >= t_end) return;
  int m = (int)(t / a.tiles);
  int tile = (int)(t - (long long)m * a.tiles);
  {
    // the rows first: they do not wait on the member index
    const int row0 = tile * TR;
    stage_rows(xbuf, a.X + ((size_t)m * a.B + row0) * a.F, min(TR, a.B - row0) * a.F);
  }
  int n = __ldg(a.indices + m);
  stage_member(smem, a, n);
  cp_async_commit();

  for (int buf = 0;; buf ^= 1) {
    const int row0 = tile * TR;
    const int rows = min(TR, a.B - row0);
    const bool more = ++t < t_end;
    int m_next = m;
    int tile_next = tile + 1;
    if (tile_next == a.tiles) {
      ++m_next;
      tile_next = 0;
    }
    int n_next = n;
    if (more) {
      // the next tile's rows fly while this one is computed
      if (m_next != m) n_next = __ldg(a.indices + m_next);
      const int next0 = tile_next * TR;
      stage_rows(xbuf + (buf ^ 1) * a.x_floats, a.X + ((size_t)m_next * a.B + next0) * a.F,
                 min(TR, a.B - next0) * a.F);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's rows, and the params if they changed
    __syncthreads();

    // a warp whose rows are all past the ragged end sits out
    if ((int)(threadIdx.x & ~31u) / S < rows) {
      narrow_rows<S>(a, smem, xbuf + buf * a.x_floats, obuf, m, row0, rows);
    }
    __syncthreads();  // the output tile is whole; nobody reads the params
    if (more && n_next != n) {
      // the next member's params fly under this tile's stores
      stage_member(smem, a, n_next);
      cp_async_commit();
    }
    store_rows(a.out + ((size_t)m * a.B + row0) * a.F_out, obuf, rows * a.F_out);
    if (!more) break;
    m = m_next;
    tile = tile_next;
    n = n_next;
  }
}

// Rows k0 .. k0 + kWideKC of a member's W[d_in][d_out] into
// dst[kWideKC][ldw], zeros past d_in and d_out; a warp a row, a lane a
// column, so the global reads are coalesced. Commits one cp.async group.
template <int NT>
__device__ __forceinline__ void stage_chunk(float* dst, const float* W, int k0, int d_in,
                                            int d_out, int ldw) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int kk = warp; kk < kWideKC; kk += NT / 32) {
    const int k = k0 + kk;
    for (int c = lane; c < ldw; c += 32) {
      const bool valid = k < d_in && c < d_out;
      cp_async4(dst + kk * ldw + c, valid ? W + (size_t)k * d_out + c : W, valid);
    }
  }
  cp_async_commit();
}

// The same arithmetic as softmax_row, on one row r of a transposed
// buffer: v[c * stride] is the row's value c.
__device__ __forceinline__ void softmax_column(float* v, int stride, int width) {
  float mx = v[0];
  for (int c = 1; c < width; ++c) mx = v[c * stride] > mx ? v[c * stride] : mx;
  float sum = 0.f;
  for (int c = 0; c < width; ++c) {
    const float e = expf(v[c * stride] - mx);
    v[c * stride] = e;
    sum += e;
  }
  for (int c = 0; c < width; ++c) v[c * stride] = v[c * stride] / sum;
}

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

template <int TB, int NT>
__global__ void __launch_bounds__(NT)
    fleet_dense_wide_kernel(const __grid_constant__ Args a) {
  constexpr int LD = TB + 4;  // row stride of the transposed activations
  constexpr int RG = TB / 8;  // groups of 8 rows
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // two activation buffers, act(i)[k * LD + r] holding row r's value k;
  // two weight chunk buffers; the bias
  auto act = [&](int i) { return smem + i * a.act_floats; };
  auto wbuf = [&](int i) { return smem + 2 * a.act_floats + i * a.w_floats; };
  float* bias = wbuf(2);

  const int m = blockIdx.x / a.tiles;
  const int tile = blockIdx.x - m * a.tiles;
  const int row0 = tile * TB;
  const int rows = min(TB, a.B - row0);
  const int n = a.indices[m];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The row tile, transposed, with the ingest affine as a prologue; zeros
  // past the last row and in the feature rows up to a whole chunk.
  {
    const float* x = a.X + ((size_t)m * a.B + row0) * a.F;
    const float* sc = a.scale ? a.scale + (size_t)n * a.F : nullptr;
    const float* of = a.offset ? a.offset + (size_t)n * a.F : nullptr;
    const int f_pad = round_up(a.F, kWideKC);
    for (int r = warp; r < TB; r += NT / 32) {
      for (int f = lane; f < f_pad; f += 32) {
        float v = 0.f;
        if (r < rows && f < a.F) {
          v = x[(size_t)r * a.F + f];
          // multiply then add, each rounded, as the plain version does
          if (sc) v = __fadd_rn(__fmul_rn(v, sc[f]), of[f]);
        }
        act(0)[f * LD + r] = v;
      }
    }
  }

  int cur = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const Layer& L = a.layers[l];
    const float* W = L.W + (size_t)n * L.d_in * L.d_out;
    const int ncg = (L.d_out + 3) / 4;  // column groups: group cg owns cg + j * ncg
    const int ldw = 4 * ncg;
    const int chunks = (L.d_in + kWideKC - 1) / kWideKC;
    const float* in = act(cur);
    float* out = act(cur ^ 1);
    for (int c = threadIdx.x; c < ldw; c += NT) {
      bias[c] = c < L.d_out ? L.b[(size_t)n * L.d_out + c] : 0.f;
    }

    for (int item0 = 0; item0 < RG * ncg; item0 += NT) {
      const int item = item0 + threadIdx.x;
      const bool active = item < RG * ncg;
      const int rg = item / ncg;
      const int cg = item - rg * ncg;
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      stage_chunk<NT>(wbuf(0), W, 0, L.d_in, L.d_out, ldw);
      for (int ch = 0; ch < chunks; ++ch) {
        if (ch + 1 < chunks) {
          stage_chunk<NT>(wbuf((ch + 1) & 1), W, (ch + 1) * kWideKC, L.d_in, L.d_out, ldw);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // chunk ch (and the tile and bias) visible to all
        if (active) {
          const float* w = wbuf(ch & 1) + cg;
          const float* xk = in + ch * kWideKC * LD + rg * 8;
#pragma unroll
          for (int kk = 0; kk < kWideKC; ++kk) {
            const float4 x0 = *reinterpret_cast<const float4*>(xk + kk * LD);
            const float4 x1 = *reinterpret_cast<const float4*>(xk + kk * LD + 4);
            const float xr[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
            float wv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) wv[j] = w[kk * ldw + j * ncg];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xr[i], wv[j], acc[i][j]);
            }
          }
        }
        __syncthreads();  // the next stage_chunk overwrites this chunk's buffer
      }
      if (active) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg + j * ncg;
          if (c < L.d_out) {
            const float bc = bias[c];
            float* o = out + c * LD + rg * 8;
            *reinterpret_cast<float4*>(o) =
                make_float4(acc[0][j] + bc, acc[1][j] + bc, acc[2][j] + bc, acc[3][j] + bc);
            *reinterpret_cast<float4*>(o + 4) =
                make_float4(acc[4][j] + bc, acc[5][j] + bc, acc[6][j] + bc, acc[7][j] + bc);
          }
        }
      }
    }
    __syncthreads();

    // The activation, then zeros in the rows up to a whole chunk, which
    // the next layer reads against its zero-padded weight rows.
    if (L.act == kSoftmax) {
      for (int r = threadIdx.x; r < TB; r += NT) softmax_column(out + r, LD, L.d_out);
    } else {
      with_activation(L.act, [&](auto code) {
        for (int e = threadIdx.x; e < L.d_out * TB; e += NT) {
          float* v = out + (e / TB) * LD + e % TB;
          *v = activate(*v, decltype(code)::value);
        }
      });
    }
    for (int e = L.d_out * TB + threadIdx.x; e < round_up(L.d_out, kWideKC) * TB; e += NT) {
      out[(e / TB) * LD + e % TB] = 0.f;
    }
    __syncthreads();
    cur ^= 1;
  }

  // The final store, a row a warp; with K2's epilogue each lane sums the
  // squared differences of its columns and a shuffle adds the lanes.
  float* o = a.out + ((size_t)m * a.B + row0) * a.F_out;
  for (int r = warp; r < rows; r += NT / 32) {  // uniform across the warp
    const float* y = a.mse ? a.y + ((size_t)m * a.B + row0 + r) * a.F_y : nullptr;
    float sum = 0.f;
    for (int c = lane; c < a.F_out; c += 32) {
      const float v = act(cur)[c * LD + r];
      o[(size_t)r * a.F_out + c] = v;
      if (y && c < a.w) {
        const float d = v - y[c];
        sum = fmaf(d, d, sum);
      }
    }
    if (a.mse) {
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, offset);
      if (lane == 0) a.mse[(size_t)m * a.B + row0 + r] = sum / (float)a.w;
    }
  }
}

// The narrow kernel's staging offsets for tiles of `tile_rows` rows,
// worked out here so the device divides nothing; returns its shared
// memory in bytes. Staged params: each layer's [d_in + 1][ldw] (W, then b
// as row d_in), then the ingest scale and offset; then two row-tile
// buffers and the output tile. Every region starts 16-byte aligned for
// float4 loads and 16-byte copies.
size_t narrow_layout(Args& a, int tile_rows) {
  int off = 0;
  int rows = 0;  // staged rows so far, dealt round-robin to the warps
  for (int l = 0; l < a.n_layers; ++l) {
    Layer& L = a.layers[l];
    L.ldw = round_up(L.d_out, 4);
    L.w_off = off;
    L.warp0 = rows % kNarrowWarps;
    off += (L.d_in + 1) * L.ldw;
    rows += L.d_in + 1;
  }
  a.ingest_off = off;
  a.ingest_warp = rows % kNarrowWarps;
  off += 2 * kNarrowWidth;
  a.stage_floats = off;
  a.x_floats = round_up(tile_rows * a.F, 4);
  // <= 183 KB at 32 layers 32 wide
  return (size_t)(off + 2 * a.x_floats + tile_rows * a.F_out) * sizeof(float);
}

template <int S>
cudaError_t narrow_blocks_per_sm(size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(fleet_dense_narrow_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fleet_dense_narrow_kernel<S>,
                                                       kNarrowThreads, smem);
}

// How the narrow kernel runs M x B rows: S lanes to a row, tiles of
// kNarrowThreads / S rows, the shared memory and blocks an SM of that
// build, and the grid. One lane a row keeps the most FMAs in flight for
// the fewest instructions, so it is the rule. Only when M x B rows make
// fewer tiles than the card has SMs (one served machine) is a launch
// waiting on one row's chain of layers; then S is the widest split (4,
// then 2) whose tiles all fit on the card at once, which cuts that chain
// about S-fold. A build with -DFLEET_DENSE_NO_SPLIT never splits, for
// chip_smoke.py to time the split against.
struct NarrowPlan {
  int split;
  size_t smem;
  int blocks_per_sm;
  long long grid;
};

int narrow_plan(Args& a, int M, NarrowPlan* plan) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long unsplit_tiles = (long long)M * ((a.B + kNarrowThreads - 1) / kNarrowThreads);
  int split = unsplit_tiles < sms ? 4 : 1;
#ifdef FLEET_DENSE_NO_SPLIT
  split = 1;
#endif
  for (;; split /= 2) {
    const int tile_rows = kNarrowThreads / split;
    const size_t smem = narrow_layout(a, tile_rows);
    int per_sm = 0;
    err = split == 4   ? narrow_blocks_per_sm<4>(smem, &per_sm)
          : split == 2 ? narrow_blocks_per_sm<2>(smem, &per_sm)
                       : narrow_blocks_per_sm<1>(smem, &per_sm);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (a.B + tile_rows - 1) / tile_rows;
    const long long n_tiles = (long long)M * tiles;
    // persistent blocks: as many as the card holds at once, at most a tile each
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (split == 1 || n_tiles <= resident) {
      a.tiles = tiles;
      a.n_tiles = n_tiles;
      *plan = {split, smem, per_sm, n_tiles < resident ? n_tiles : resident};
      return 0;
    }
  }
}

int launch_narrow(Args& a, int M, cudaStream_t stream) {
  NarrowPlan p;
  const int status = narrow_plan(a, M, &p);
  if (status != 0) return status;
  const unsigned grid = (unsigned)p.grid;
  if (p.split == 4) {
    fleet_dense_narrow_kernel<4><<<grid, kNarrowThreads, p.smem, stream>>>(a);
  } else if (p.split == 2) {
    fleet_dense_narrow_kernel<2><<<grid, kNarrowThreads, p.smem, stream>>>(a);
  } else {
    fleet_dense_narrow_kernel<1><<<grid, kNarrowThreads, p.smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int TB, int NT>
int launch_wide(Args& a, int M, int max_width, cudaStream_t stream) {
  // shared memory: two transposed activation buffers, two weight chunks,
  // the bias; at most 215 KB (512 wide, TB = 32)
  a.act_floats = round_up(max_width, kWideKC) * (TB + 4);
  a.w_floats = kWideKC * round_up(max_width, 4);
  const size_t smem =
      (size_t)(2 * a.act_floats + 2 * a.w_floats + round_up(max_width, 4)) * sizeof(float);
  a.tiles = (a.B + TB - 1) / TB;
  cudaError_t err = cudaFuncSetAttribute(
      fleet_dense_wide_kernel<TB, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)M * a.tiles;
  if (blocks > 0x7fffffffLL) return kBadShape;
  fleet_dense_wide_kernel<TB, NT><<<(unsigned)blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K1, or K2 when y and mse are given, on `stream` and returns 0,
// a negative argument-check code, or the cudaError_t of the launch. Does
// not synchronise.
//   y, mse, F_y: targets [M, B, F_y] and the per-row MSE [M, B], both null
//     for K1; y may be X itself (then F_y must be F)
//   weights[l], biases[l]: device pointers of layer l's W and b
//   dims[0..n_layers]: F, the hidden widths, F_out
//   acts[l]: activation code of layer l
int fleet_dense_forward(const float* X, float* out, const float* y, float* mse, int F_y,
                        const int* indices, const float* scale, const float* offset, int M,
                        int B, int n_layers, const void* const* weights,
                        const void* const* biases, const int* dims, const int* acts,
                        void* stream) {
  if (M < 0 || B < 0 || n_layers < 1) return kBadShape;
  if (n_layers > kMaxLayers) return kTooManyLayers;
  if ((y == nullptr) != (mse == nullptr)) return kBadPointer;
  if (mse && F_y < 1) return kBadShape;
  if (M == 0 || B == 0) return 0;
  if (!X || !out || !indices || (scale == nullptr) != (offset == nullptr)) return kBadPointer;
  Args a = {};
  a.X = X;
  a.out = out;
  a.indices = indices;
  a.scale = scale;
  a.offset = offset;
  a.y = y;
  a.mse = mse;
  a.B = B;
  a.F = dims[0];
  a.F_out = dims[n_layers];
  a.n_layers = n_layers;
  a.F_y = F_y;
  a.w = F_y < a.F_out ? F_y : a.F_out;
  if (y == X && F_y != a.F) return kBadShape;
  int max_width = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return kBadShape;
    if (dims[l] > kMaxWidth) return kTooWide;
    max_width = dims[l] > max_width ? dims[l] : max_width;
  }
  for (int l = 0; l < n_layers; ++l) {
    if (acts[l] < 0 || acts[l] >= kNumActs) return kBadActivation;
    if (!weights[l] || !biases[l]) return kBadPointer;
    a.layers[l].W = static_cast<const float*>(weights[l]);
    a.layers[l].b = static_cast<const float*>(biases[l]);
    a.layers[l].d_in = dims[l];
    a.layers[l].d_out = dims[l + 1];
    a.layers[l].act = acts[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifndef FLEET_DENSE_WIDE_ONLY
  // A build with -DFLEET_DENSE_WIDE_ONLY sends narrow specs to the wide
  // kernel too, and chip_smoke.py times it beside this one: on an H100 the
  // wide kernel takes 4.9x the narrow one's time on hourglass(20) at
  // 1000 x 1008 rows, 3.7x at 64 x 1008 and 1.9x at 1 x 1008.
  if (max_width <= kNarrowWidth) return launch_narrow(a, M, s);
#endif
  // 16 warps a block beat 8 on feedforward_model's 256-wide layers and
  // lose on a 40-wide hourglass, whose narrow layers leave most idle
  if (max_width <= 128) return launch_wide<64, 256>(a, M, max_width, s);
  if (max_width <= 256) return launch_wide<64, 512>(a, M, max_width, s);
  return launch_wide<32, 512>(a, M, max_width, s);
}

// How the narrow kernel would run M x B rows of a spec (dims as for
// fleet_dense_forward, every width at most 32): the lanes a row, the
// shared memory a block, the blocks an SM holds at once and the grid.
// Returns 0 or an error code as fleet_dense_forward does.
int fleet_dense_narrow_occupancy(int n_layers, const int* dims, int M, int B, int* split,
                                 int* smem_bytes, int* blocks_per_sm, int* grid) {
  if (n_layers < 1 || M < 1 || B < 1) return kBadShape;
  if (n_layers > kMaxLayers) return kTooManyLayers;
  Args a = {};
  a.B = B;
  a.F = dims[0];
  a.F_out = dims[n_layers];
  a.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return kBadShape;
    if (dims[l] > kNarrowWidth) return kTooWide;
  }
  for (int l = 0; l < n_layers; ++l) {
    a.layers[l].d_in = dims[l];
    a.layers[l].d_out = dims[l + 1];
  }
  NarrowPlan p;
  const int status = narrow_plan(a, M, &p);
  if (status != 0) return status;
  *split = p.split;
  *smem_bytes = (int)p.smem;
  *blocks_per_sm = p.blocks_per_sm;
  *grid = (int)p.grid;
  return 0;
}

const char* fleet_dense_error_string(int code) {
  switch (code) {
    case kBadShape:
      return "bad shape (M, B or a width below 1, y aliasing X at another width, or too many blocks)";
    case kTooManyLayers:
      return "too many layers for the kernel's argument block";
    case kTooWide:
      return "a layer is wider than the kernel's maximum width";
    case kBadActivation:
      return "unknown activation code";
    case kBadPointer:
      return "null pointer argument";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
