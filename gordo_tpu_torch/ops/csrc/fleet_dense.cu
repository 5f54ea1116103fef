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

// Wider specs (up to kMaxWidth = 512): fleet_dense_wide_kernel<R, WF>,
// the layer sums on the tensor cores. What bounds it: feedforward_model(20)
// is ~1,000 flops a byte, so the rate of f32-accurate products; exact
// f32 FMAs top out at 67 TFLOP/s, while 3xTF32 on the tensor cores
// (495 TFLOP/s TF32, three products a multiply-add) gives ~165
// f32-equivalent TFLOP/s. A 40-wide hourglass is bound by its bytes.
// Measured, both are bound by latency instead (PERF.md): the parts (sums,
// exact activations, weight streaming) add up rather than overlap.
//   - 3xTF32 mma.sync.m16n8k8: each f32 operand x is split into
//     hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and a product is
//     lo*hi + hi*lo + hi*hi, the small terms first, summed in f32 by the
//     tensor core; the dropped lo*lo is ~2^-22 of the product, so the sum
//     keeps f32 accuracy. The A split (activations) is made once a k step
//     and reused across all the warp's n-fragments; per group of 8
//     fragments the three products go out in waves (every lo*hi, then
//     every hi*lo, then every hi*hi), so 8 independent products stand
//     between two that share an accumulator. A non-finite activation
//     keeps lo = 0, so inf and NaN pass through hi alone. mma.sync, not
//     wgmma: a warp owns 16 rows and walks every layer on its own (below),
//     which wgmma's 64-row warpgroup tiles would undo for the 20-40-wide
//     layers of served specs.
//   - Rows are dealt to warps before columns: 16 warps, each owning a
//     16-row slice of the block's row tile (TR = 256 rows) and every
//     n-fragment of every layer, so a 20-wide head keeps every warp busy.
//     When a tile has fewer rows (TR = 128, 64, 32, 16: shared memory or
//     few rows force it) 2, 4, 8 or 16 warps share a slice, each taking
//     every wpr-th fragment. A warp holds at most 16 fragments (64
//     accumulators); a layer that would give it 9-16 is padded to 16 a
//     warp (zero weights in the padding; WF = true, a build of its own).
//   - The slice's activations sit in one shared-memory buffer (row stride
//     lda = widest layer rounded to 8, plus 4: = 4 mod 8, so the A
//     fragment loads hit 32 banks) and every layer works in place: a warp
//     sums all its fragments over every k, then, once every warp of the
//     slice is done reading its rows, writes the layer back over them.
//     One buffer instead of two is what lets feedforward_model's
//     256-wide rows take 128-row tiles. A warp touches only its slice, so
//     with one warp a slice layers need only __syncwarp.
//   - Depth and columns are padded to 8 (not 16 or 4 column groups):
//     padded weight rows and columns are zero, the padded input columns
//     are zeros, and padded output columns (act(0), finite) meet only zero
//     weight rows in the next layer and never reach out or the MSE.
//   - Weights, R = true (resident): when a member's whole stack fits
//     beside the tiles (hourglass(40): 8,384 padded weights, 33 KB), it
//     is staged once per member change, zero-filled, in rows of ldw = 8
//     mod 16 floats (the B fragment loads hit 32 banks). R = false
//     (streamed, feedforward_model): every layer is cut into k chunks of
//     the whole layer's width, as many rows as a stage holds, that stream
//     through a ring of 4 shared-memory stages, three tiles ahead of the
//     one multiplied, across layer and row-tile boundaries, so the next
//     layer's first tiles fly under the current layer's epilogue. One
//     cp.async group and one __syncthreads a tile: every warp consumes
//     every tile, so the barrier is the wait all of them need anyway
//     (an mbarrier ring would let no warp run further ahead than the
//     stage it waits on). Copies are 16-byte cp.async where W's rows are
//     16-byte aligned, and 4-byte ones at odd widths (33 x 27 x 4 = 3,564
//     bytes a member is not).
//   - Persistent blocks walk contiguous runs of (batch row, row tile), as
//     the narrow kernel does, with the raw row tile and the tile's small
//     params (every layer's bias, the ingest scale and offset)
//     double-buffered: tile t + 1's fly while tile t is computed. The host
//     works out every offset (wide_layout), so the device divides nothing.
//   - The epilogue works on the accumulators: bias after the sum, then
//     the exact activate() in registers. Softmax is a pass over the
//     slice's own rows. K2's MSE and the coalesced final store walk the
//     slice's rows, lanes over columns, with a warp shuffle for each
//     row's sum, y = X read from the raw tile still in shared memory.
//   - Few rows still spread: the row tile is halved (down to 16 rows)
//     while M x B rows make fewer tiles than SMs, so the served anomaly
//     request (M = 1, B = 1008: 63 tiles of 16 rows) runs on 63 SMs, not 4.

// The narrow kernel sums in plain f32 FMAs, k in order, the wide one in
// 3xTF32 on the tensor cores; both add the bias after the sum, as the
// plain version's bmm + b does.
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
//   - Wide kernel: the final store walks the slice's rows, lanes striding
//     a row's columns; each lane sums its squares, a warp shuffle adds
//     them, and lane 0 writes the row's mse. y = X comes from the raw
//     tile in shared memory, as in the narrow kernel.
// Padded weight columns (narrow: widths rounded up to 4; wide: to 8)
// never enter the sum: it runs over the real columns j < w only.
//
// Neither kernel uses fast math or *.approx intrinsics; only the wide
// kernel's products go through TF32, three to an f32 product.
//
// Builds for measurement only (chip_smoke.py, scripts/narrow_ablation.py):
// -DFLEET_DENSE_WIDE_ONLY sends narrow specs to the wide kernel;
// -DFLEET_DENSE_NO_SPLIT never shares a row among lanes; and
// -DFLEET_DENSE_SKIP_FMAS / -DFLEET_DENSE_SKIP_ACTIVATIONS leave both
// kernels' layer sums or activations out, and -DFLEET_DENSE_SKIP_SPLIT
// the wide kernel's hi/lo split of the weights (hi the raw f32, lo 0),
// computing wrong answers on purpose, so that the time of each part shows
// apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 32;
constexpr int kMaxWidth = 512;
constexpr int kNarrowWidth = 32;
constexpr int kNarrowThreads = 128;  // threads a block of the narrow kernel
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kWideThreads = 512;  // threads a block of the wide kernel
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideMaxRows = 16 * kWideWarps;  // rows a tile with one warp a slice
constexpr int kWideMaxFrags = 16;  // n-fragments a warp holds at most (64 accumulators)
constexpr int kWideStages = 4;                 // streamed tiles in the ring
constexpr int kWideMaxSmem = 232448;           // shared memory a block can have (H100)

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
  // worked out on the host:
  int ldw;    // the staged row length: narrow, d_out rounded up to 4;
              // wide, n8 or n8 + 8, whichever is 8 mod 16
  int w_off;  // offset of the staged W, in floats; narrow: b is its row d_in
  int warp0;  // narrow: the warp that stages row 0 (the rows of all
              // layers are dealt round-robin to the warps)
  int k8;       // wide: d_in rounded up to 8
  int n8p;      // wide: d_out rounded up to 8, or to 8 x fw x warps a slice
  int fw;       // wide: fragments a warp holds when above 8, else 0
  int kc;       // wide, streamed: k rows a ring tile
  int kchunks;  // wide, streamed: ring tiles of the layer, ceil(k8 / kc)
  int b_off;    // wide: offset of b (n8p floats) in a tile's staged params
  int vec;      // wide: W's rows are 16-byte aligned (16-byte copies)
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
  long long n_tiles;    // M * tiles
  int ingest_off;       // narrow kernel: offset of the staged scale, offset
  int ingest_warp;      // narrow kernel: the warp that stages scale
  int stage_floats;     // narrow kernel: floats of the staged params
  int x_floats;         // narrow kernel: floats of one row-tile buffer
  int tile_rows;        // wide kernel: rows a tile (TR), 16 x slices
  int wpr_shift;        // wide kernel: log2 of the warps a 16-row slice
  int lda;              // wide kernel: row stride of the activations
  int act_off;          // wide kernel: offset of the activation buffer
  int raw_off;          // wide kernel: offset of the two raw row-tile buffers
  int raw_floats;       // wide kernel: floats of one raw buffer
  int ring_tiles;       // wide kernel, streamed: weight tiles a row tile
  int ring_stage;       // wide kernel, streamed: floats of a ring stage
  int prm_off;          // wide kernel: offset of the two buffers of a tile's params
  int prm_floats;       // wide kernel: floats of one: every layer's b, then scale, offset
  int sc_off;           // wide kernel: offset of scale in it (offset follows at + f4)
  int f4;               // wide kernel: F rounded up to 4
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

// 16 bytes, or 16 zeros (reading nothing) when valid is false.
__device__ __forceinline__ void cp_async16z(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
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
// 16 bytes a copy where src is 16-byte aligned too; NT threads take part.
template <int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = 4 * threadIdx.x; i + 4 <= n; i += 4 * NT) cp_async16(dst + i, src + i);
    i0 = n & ~3;
  }
  for (int i = i0 + threadIdx.x; i < n; i += NT) cp_async4(dst + i, src + i, true);
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
    stage_rows<kNarrowThreads>(xbuf, a.X + ((size_t)m * a.B + row0) * a.F, min(TR, a.B - row0) * a.F);
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
      stage_rows<kNarrowThreads>(xbuf + (buf ^ 1) * a.x_floats, a.X + ((size_t)m_next * a.B + next0) * a.F,
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

// The same arithmetic as softmax_row, on one row: v[c * stride] is the
// row's value c.
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

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as the
// bits of an f32 whose low 13 bits are zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~22 bits. With kGuard (activations), lo = 0 when x is
// not finite, so inf and NaN pass through hi alone (x - hi would be NaN
// for an inf); weights are finite and go unguarded.
template <bool kGuard>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  const float rest = x - __uint_as_float(hi);
  lo = to_tf32(kGuard && !isfinite(rest) ? 0.f : rest);
}

// c += a b on the tensor cores: one m16n8k8 product of TF32 operands,
// summed in f32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i] += in x w over `ksteps` k steps of 8 for the warp's FW
// n-fragments f = part + i * wpr, in 3xTF32: per k step, for each group of
// up to 8 fragments, every lo*hi, then every hi*lo, then every hi*hi, so
// that up to 8 independent products stand between two that share an
// accumulator; the A split is made once a k step for all FW fragments.
// `in` is the slice's row 0 at the first k (row stride lda); `w` the
// weights at that k, column 0 (row stride ldw). Fragments (g = lane / 4,
// t = lane % 4): A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); B b0 (k t, n g), b1 (k t + 4, n g).
template <int FW>
__device__ __forceinline__ void mma_steps(float (&acc)[FW][4], const float* in, int lda, const float* w,
                                          int ldw, int ksteps, int part, int wpr) {
  constexpr int kGroup = FW < 8 ? FW : 8;
  constexpr int kUnroll = FW <= 8 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* a0 = in + g * lda + t;
  const float* a1 = a0 + 8 * lda;
  const float* b = w + t * ldw + g + 8 * part;
  const int fstride = 8 * wpr;
#pragma unroll kUnroll
  for (int s = 0; s < ksteps; ++s) {
    const float av[4] = {a0[8 * s], a1[8 * s], a0[8 * s + 4], a1[8 * s + 4]};
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32<true>(av[j], ahi[j], alo[j]);
    const float* bk = b + 8 * s * ldw;
#pragma unroll
    for (int g0 = 0; g0 < FW; g0 += kGroup) {
      float bv[kGroup][2];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        bv[i][0] = bk[(g0 + i) * fstride];
        bv[i][1] = bk[(g0 + i) * fstride + 4 * ldw];
      }
      uint32_t bhi[kGroup][2], blo[kGroup][2];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
#ifdef FLEET_DENSE_SKIP_SPLIT
        bhi[i][0] = __float_as_uint(bv[i][0]);
        bhi[i][1] = __float_as_uint(bv[i][1]);
        blo[i][0] = blo[i][1] = 0u;
#else
        split_tf32<false>(bv[i][0], bhi[i][0], blo[i][0]);
        split_tf32<false>(bv[i][1], bhi[i][1], blo[i][1]);
#endif
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) mma_tf32(acc[g0 + i], alo, bhi[i][0], bhi[i][1]);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) mma_tf32(acc[g0 + i], ahi, blo[i][0], blo[i][1]);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) mma_tf32(acc[g0 + i], ahi, bhi[i][0], bhi[i][1]);
    }
  }
}

// `cols` floats (a multiple of 8) of weight row k of a member's W into
// dst, zeros past d_in and d_out; a warp a row, lanes over the columns
// (coalesced reads). 16-byte copies where W's rows are 16-byte aligned
// (then d_out is a multiple of 4, so a copy is all in or all out); else
// 4-byte ones (odd widths: 33 x 27 x 4 = 3,564 bytes a member).
__device__ __forceinline__ void copy_w_row(float* dst, const float* W, const Layer& L, int k, int cols) {
  const int lane = threadIdx.x & 31;
  const bool row = k < L.d_in;
  const float* src = row ? W + (size_t)k * L.d_out : W;
  const int valid_cols = row ? L.d_out : 0;
  if (L.vec) {
    for (int c = 4 * lane; c < cols; c += 128) {
      const bool valid = c < valid_cols;
      cp_async16z(dst + c, valid ? src + c : W, valid);
    }
  } else {
    for (int c = lane; c < cols; c += 32) {
      const bool valid = c < valid_cols;
      cp_async4(dst + c, valid ? src + c : W, valid);
    }
  }
}

// Member n's whole stack into the resident weights: each layer's W as
// [k8][ldw] at w_off, zeros past d_in and d_out. The caller commits.
__device__ __forceinline__ void stage_stack(float* dst, const Args& a, int n) {
  const int warp = threadIdx.x >> 5;
  for (int l = 0; l < a.n_layers; ++l) {
    const Layer& L = a.layers[l];
    const float* W = L.W + (size_t)n * L.d_in * L.d_out;
    for (int k = warp; k < L.k8; k += kWideWarps) copy_w_row(dst + L.w_off + k * L.ldw, W, L, k, L.n8p);
  }
}

// Member n's small params for a row tile into dst: every layer's b at
// b_off (zeros past d_out), then the ingest scale and offset. The caller
// commits.
__device__ __forceinline__ void stage_params(float* dst, const Args& a, int n) {
  for (int l = 0; l < a.n_layers; ++l) {
    const Layer& L = a.layers[l];
    const float* b = L.b + (size_t)n * L.d_out;
    for (int c = threadIdx.x; c < L.n8p; c += kWideThreads) {
      cp_async4(dst + L.b_off + c, c < L.d_out ? b + c : b, c < L.d_out);
    }
  }
  if (a.scale) {
    for (int c = threadIdx.x; c < a.F; c += kWideThreads) {
      cp_async4(dst + a.sc_off + c, a.scale + (size_t)n * a.F + c, true);
      cp_async4(dst + a.sc_off + a.f4 + c, a.offset + (size_t)n * a.F + c, true);
    }
  }
}

// The streamed ring: where its producer stands (the next weight tile to
// issue: k chunk kc of layer l of row tile t, whose batch row is m, member
// n), the stage it fills next and the stage the next consumed tile is in.
struct Ring {
  long long t, t_end;
  int m, tile, n;
  int l, kc;
  int pstage, stage;
};

// Issues the producer's weight tile into its stage, rows kc * L.kc on of
// the layer's W as [L.kc][ldw] (zeros past d_in and d_out), commits it as
// one group and steps the producer on, across layers and row tiles; past
// the block's last tile it commits an empty group, so that every step
// commits one.
__device__ __forceinline__ void issue_tile(float* smem, const Args& a, Ring& r) {
  if (r.t < r.t_end) {
    const Layer& L = a.layers[r.l];
    const int warp = threadIdx.x >> 5;
    const float* W = L.W + (size_t)r.n * L.d_in * L.d_out;
    float* dst = smem + r.pstage * a.ring_stage;
    const int k0 = r.kc * L.kc;
    const int rows = min(L.kc, L.k8 - k0);
    for (int kk = warp; kk < rows; kk += kWideWarps) copy_w_row(dst + kk * L.ldw, W, L, k0 + kk, L.n8p);
    if (++r.kc == L.kchunks) {
      r.kc = 0;
      if (++r.l == a.n_layers) {
        r.l = 0;
        ++r.t;
        if (++r.tile == a.tiles) {
          r.tile = 0;
          ++r.m;
          if (r.t < r.t_end) r.n = __ldg(a.indices + r.m);
        }
      }
    }
  }
  cp_async_commit();
  r.pstage = r.pstage == kWideStages - 1 ? 0 : r.pstage + 1;
}

// The next streamed tile, once every thread's copies of it have landed:
// its stage. The barrier also tells that every warp is done with the
// stage refilled next, so the producer issues into it here.
__device__ __forceinline__ const float* ring_next(float* smem, const Args& a, Ring& r) {
  cp_async_wait<kWideStages - 2>();
  __syncthreads();
  issue_tile(smem, a, r);
  const float* w = smem + r.stage * a.ring_stage;
  r.stage = r.stage == kWideStages - 1 ? 0 : r.stage + 1;
  return w;
}

// One layer for the warp's FW n-fragments (FW may be 0: the warp still
// takes part in the barriers), in place on the slice's rows v (row stride
// lda): the sums over every k (resident weights, or the ring's k chunks),
// then, once every warp of the slice is done reading its rows, the
// epilogue on the accumulators: bias after the sum (`bias`, the layer's b
// in the tile's staged params, zeros past d_out), the activation in
// registers (softmax is left to a pass over the finished rows), the rows
// back in place. C fragments: c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, 2t,
// 2t + 1).
template <int FW, bool kResident>
__device__ __forceinline__ void layer_pass(float* smem, const Args& a, const Layer& L, Ring& r, float* v,
                                           const float* bias, int part, int wpr, int act) {
  const int lda = a.lda;
  if constexpr (FW == 0) {
    if (!kResident) {
      for (int kc = 0; kc < L.kchunks; ++kc) ring_next(smem, a, r);
    }
    if (wpr > 1) __syncthreads();
  } else {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    float acc[FW][4];
#pragma unroll
    for (int i = 0; i < FW; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
#ifndef FLEET_DENSE_SKIP_FMAS
    if (kResident) {
      mma_steps<FW>(acc, v, lda, smem + L.w_off, L.ldw, L.k8 >> 3, part, wpr);
    } else {
      for (int kc = 0; kc < L.kchunks; ++kc) {
        const float* w = ring_next(smem, a, r);
        const int k0 = kc * L.kc;
        mma_steps<FW>(acc, v + k0, lda, w, L.ldw, min(L.kc, L.k8 - k0) >> 3, part, wpr);
      }
    }
#else
    if (!kResident) {
      for (int kc = 0; kc < L.kchunks; ++kc) ring_next(smem, a, r);
    }
#endif
#pragma unroll
    for (int i = 0; i < FW; ++i) {
      const int col = 8 * (part + i * wpr) + 2 * t;
      const float b0 = bias[col];
      const float b1 = bias[col + 1];
      acc[i][0] += b0;
      acc[i][1] += b1;
      acc[i][2] += b0;
      acc[i][3] += b1;
    }
    with_activation(act, [&](auto code) {
#pragma unroll
      for (int i = 0; i < FW; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = activate(acc[i][j], decltype(code)::value);
      }
    });
    // every warp of the slice is done reading its rows
    if (wpr == 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < FW; ++i) {
      const int col = 8 * (part + i * wpr) + 2 * t;
      *reinterpret_cast<float2*>(v + g * lda + col) = make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(v + (g + 8) * lda + col) = make_float2(acc[i][2], acc[i][3]);
    }
  }
}

// layer_pass for the warp's fragment count: up to 8, or (kWideFrags) 16,
// a layer wider than 8 fragments a warp, padded.
template <bool kResident, bool kWideFrags>
__device__ __forceinline__ void layer_for(int fw, float* smem, const Args& a, const Layer& L, Ring& r,
                                          float* v, const float* bias, int part, int wpr, int act) {
  switch (fw) {
#define FLEET_DENSE_LAYER(FW) \
  case FW:                    \
    layer_pass<FW, kResident>(smem, a, L, r, v, bias, part, wpr, act); \
    break;
    FLEET_DENSE_LAYER(0)
    FLEET_DENSE_LAYER(1)
    FLEET_DENSE_LAYER(2)
    FLEET_DENSE_LAYER(3)
    FLEET_DENSE_LAYER(4)
    FLEET_DENSE_LAYER(5)
    FLEET_DENSE_LAYER(6)
    FLEET_DENSE_LAYER(7)
    FLEET_DENSE_LAYER(8)
#undef FLEET_DENSE_LAYER
    default:
      if constexpr (kWideFrags) layer_pass<kWideMaxFrags, kResident>(smem, a, L, r, v, bias, part, wpr, act);
      break;
  }
}

// Shared memory (floats, every region 16-byte aligned): resident, the
// member's stack (sum of k8 x ldw); streamed, the ring (kWideStages x
// ring_stage); then the activation buffer of tile_rows x lda, two raw
// row-tile buffers of raw_floats and two buffers of a tile's params
// (biases, ingest scale and offset) of prm_floats, the next tile's raw
// rows and params in flight while this tile is computed. kWideFrags: some
// layer gives a warp 16 fragments. Its registers spill where they do not
// (108 bytes against 4), so specs whose warps hold 8 fragments at most get
// a build without that path.
template <bool kResident, bool kWideFrags>
__global__ void __launch_bounds__(kWideThreads, 1)
    fleet_dense_wide_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wpr = 1 << a.wpr_shift;  // warps a slice
  const int slice = warp >> a.wpr_shift;
  const int part = warp & (wpr - 1);
  const int lda = a.lda;
  const int TR = a.tile_rows;
  float* v = smem + a.act_off + slice * 16 * lda;  // the slice's rows
  float* raw = smem + a.raw_off;
  float* prm = smem + a.prm_off;

  // this block's run of the flattened (batch row, tile) sequence
  long long t = (long long)blockIdx.x * a.n_tiles / gridDim.x;
  const long long t_end = (long long)(blockIdx.x + 1) * a.n_tiles / gridDim.x;
  if (t >= t_end) return;
  int m = (int)(t / a.tiles);
  int tile = (int)(t - (long long)m * a.tiles);
  stage_rows<kWideThreads>(raw, a.X + ((size_t)m * a.B + tile * TR) * a.F, min(TR, a.B - tile * TR) * a.F);
  int n = __ldg(a.indices + m);
  stage_params(prm, a, n);
  cp_async_commit();
  Ring ring = {t, t_end, m, tile, n, 0, 0, 0, 0};
  if (kResident) {
    stage_stack(smem, a, n);
    cp_async_commit();
  } else {
    for (int i = 0; i < kWideStages - 1; ++i) issue_tile(smem, a, ring);
  }

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
    const int n_next = more && m_next != m ? __ldg(a.indices + m_next) : n;
    // this tile's rows and params (resident: and the member's stack).
    // Streamed, they went out in a group that at least kWideStages - 1
    // ring tiles followed, when a row tile has that many tiles or more.
    if (kResident || a.ring_tiles < kWideStages) {
      cp_async_wait<0>();
    } else {
      cp_async_wait<kWideStages - 1>();
    }
    __syncthreads();  // visible to all; every warp is done with the last tile
    const float* xr = raw + buf * a.raw_floats;
    const float* params = prm + buf * a.prm_floats;
    if (more) {
      // the next tile's rows and params fly while this one is computed
      // (streamed: they join the ring's next group)
      stage_rows<kWideThreads>(raw + (buf ^ 1) * a.raw_floats,
                               a.X + ((size_t)m_next * a.B + tile_next * TR) * a.F,
                               min(TR, a.B - tile_next * TR) * a.F);
      stage_params(prm + (buf ^ 1) * a.prm_floats, a, n_next);
      if (kResident) cp_async_commit();
    }

    // the prologue: the slice's rows with the ingest affine, zeros past
    // the ragged end and up to k8
    {
      const float* sc = params + a.sc_off;
      const float* of = sc + a.f4;
      const int k8 = a.layers[0].k8;
      for (int r = part; r < 16; r += wpr) {
        const int row = slice * 16 + r;
        for (int c = lane; c < k8; c += 32) {
          float x = 0.f;
          if (row < rows && c < a.F) {
            x = xr[row * a.F + c];
            // multiply then add, each rounded, as the plain version does
            if (a.scale) x = __fadd_rn(__fmul_rn(x, sc[c]), of[c]);
          }
          v[r * lda + c] = x;
        }
      }
    }
    if (wpr == 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }

    for (int l = 0; l < a.n_layers; ++l) {
      const Layer& L = a.layers[l];
#ifdef FLEET_DENSE_SKIP_ACTIVATIONS
      const int act = kLinear;
#else
      const int act = L.act;
#endif
      // the warp's fragments: part, part + wpr, ... (below nf, or fw of
      // them where the layer was padded to whole groups of 8)
      const int nf = L.n8p >> 3;
      const int fw = L.fw ? L.fw : part < nf ? ((nf - part - 1) >> a.wpr_shift) + 1 : 0;
      layer_for<kResident, kWideFrags>(fw, smem, a, L, ring, v, params + L.b_off, part, wpr, act);
      // the layer's output is whole for the slice
      if (wpr == 1) {
        __syncwarp();
      } else {
        __syncthreads();
      }
      if (act == kSoftmax) {
        if (part == 0 && lane < 16) softmax_column(v + lane * lda, 1, L.d_out);
        if (wpr == 1) {
          __syncwarp();
        } else {
          __syncthreads();
        }
      }
    }

    // The final store, the slice's rows, lanes over a row's columns; with
    // K2's epilogue each lane sums the squared differences of its columns
    // and a shuffle adds the lanes. y = X is the raw row in shared memory.
    {
      float* o = a.out + ((size_t)m * a.B + row0) * a.F_out;
      for (int r = part; r < 16; r += wpr) {
        const int row = slice * 16 + r;
        if (row >= rows) break;  // uniform across the warp
        const float* y = !a.mse ? nullptr
                         : a.y == a.X ? xr + row * a.F
                                      : a.y + ((size_t)m * a.B + row0 + row) * a.F_y;
        float sum = 0.f;
        for (int c = lane; c < a.F_out; c += 32) {
          const float x = v[r * lda + c];
          o[(size_t)row * a.F_out + c] = x;
          if (y && c < a.w) {
            const float d = x - y[c];
            sum = fmaf(d, d, sum);
          }
        }
        if (a.mse) {
#pragma unroll
          for (int offset = 16; offset > 0; offset >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, offset);
          if (lane == 0) a.mse[(size_t)m * a.B + row0 + row] = sum / (float)a.w;
        }
      }
    }
    if (!more) break;
    if (kResident && n_next != n) {
      __syncthreads();  // nobody reads the old member's stack any more
      stage_stack(smem, a, n_next);
      cp_async_commit();
    }
    m = m_next;
    tile = tile_next;
    n = n_next;
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

// The wide kernel's layout for tiles of `tile_rows` rows (wpr = 128 /
// tile_rows warps a 16-row slice), worked out here so the device divides
// nothing; returns its shared memory in bytes, or 0 if some layer would
// give a warp more than kWideMaxFrags fragments. Per layer: k8; the
// fragments a warp holds (fw, set when above 8: then kWideMaxFrags, and
// the layer's columns padded to 8 x fw x wpr, n8p; else every warp takes
// part + i * wpr below n8 / 8); the row stride ldw of the resident stack
// and of a ring tile (= 8 mod 16, so the B fragment loads hit 32 banks),
// w_off, b_off, and whether W's rows allow 16-byte copies. Then the activation stride lda (= 4 mod 8, for the A fragment
// loads), the ring's stage size and each layer's k rows a tile (kc), and
// the offsets of every region.
size_t wide_layout(Args& a, int tile_rows, bool resident) {
  const int wpr = kWideMaxRows / tile_rows;
  a.wpr_shift = 0;
  while ((1 << a.wpr_shift) < wpr) ++a.wpr_shift;
  int off = 0;
  int prm = 0;  // floats of a tile's params so far
  int widest = round_up(a.F, 8);
  int min_stage = 0, max_stage = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    Layer& L = a.layers[l];
    L.k8 = round_up(L.d_in, 8);
    const int nf = round_up(L.d_out, 8) / 8;
    int fw = (nf + wpr - 1) / wpr;
    if (fw > kWideMaxFrags) return 0;
    L.fw = fw > 8 ? kWideMaxFrags : 0;
    L.n8p = L.fw ? 8 * L.fw * wpr : 8 * nf;
    L.ldw = L.n8p % 16 == 8 ? L.n8p : L.n8p + 8;
    L.w_off = off;
    off += L.k8 * L.ldw;
    L.b_off = prm;
    prm += L.n8p;
    L.vec = L.d_out % 4 == 0 && (reinterpret_cast<uintptr_t>(L.W) & 15) == 0;
    widest = L.n8p > widest ? L.n8p : widest;
    min_stage = 8 * L.ldw > min_stage ? 8 * L.ldw : min_stage;
    max_stage = L.k8 * L.ldw > max_stage ? L.k8 * L.ldw : max_stage;
  }
  a.f4 = round_up(a.F, 4);
  a.sc_off = prm;
  a.prm_floats = prm + 2 * a.f4;
  a.tile_rows = tile_rows;
  a.lda = widest + 4;
  a.raw_floats = round_up(tile_rows * a.F, 4);
  const int tail = tile_rows * a.lda + 2 * a.raw_floats + 2 * a.prm_floats;
  a.ring_tiles = 0;
  a.ring_stage = 0;
  if (!resident) {
    // the ring takes what is left, at most a whole layer a stage
    int stage = (kWideMaxSmem / (int)sizeof(float) - tail) / kWideStages / 4 * 4;
    if (stage < min_stage) stage = min_stage;  // too big: the caller sees the size
    a.ring_stage = stage < max_stage ? stage : max_stage;
    for (int l = 0; l < a.n_layers; ++l) {
      Layer& L = a.layers[l];
      const int kc = a.ring_stage / L.ldw / 8 * 8;
      L.kc = kc < L.k8 ? kc : L.k8;
      L.kchunks = (L.k8 + L.kc - 1) / L.kc;
      a.ring_tiles += L.kchunks;
    }
    off = kWideStages * a.ring_stage;
  }
  a.act_off = off;
  a.raw_off = a.act_off + tile_rows * a.lda;
  a.prm_off = a.raw_off + 2 * a.raw_floats;
  return (size_t)(off + tail) * sizeof(float);
}

template <bool R, bool WF>
cudaError_t wide_blocks_per_sm(size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(fleet_dense_wide_kernel<R, WF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fleet_dense_wide_kernel<R, WF>,
                                                       kWideThreads, smem);
}

// How the wide kernel runs M x B rows: resident weights if the member's
// stack fits beside tiles of 32 rows or more, else streamed; the largest
// row tile (128, 64, 32, 16 rows) that fits, halved while M x B rows
// make fewer tiles than the card has SMs; whether a layer gives a warp
// 16 fragments (the build with that path); its shared memory, blocks an
// SM and a persistent grid of at most a tile a block.
struct WidePlan {
  bool resident;
  bool wide_frags;
  int tile_rows;
  size_t smem;
  int blocks_per_sm;
  long long grid;
};

int wide_plan(Args& a, int M, WidePlan* plan) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  auto fits = [&](int tr, bool resident) {
    const size_t bytes = wide_layout(a, tr, resident);
    return bytes > 0 && bytes <= (size_t)kWideMaxSmem;
  };
  bool resident = false;
  int tile_rows = 0;
  for (int tr = kWideMaxRows; tr >= 32 && !tile_rows; tr /= 2) {
    if (fits(tr, true)) resident = true, tile_rows = tr;
  }
  for (int tr = kWideMaxRows; tr >= 16 && !tile_rows; tr /= 2) {
    if (fits(tr, false)) tile_rows = tr;
  }
  if (!tile_rows) return kTooWide;
  while (tile_rows > 16 && (long long)M * ((a.B + tile_rows - 1) / tile_rows) < sms &&
         fits(tile_rows / 2, resident)) {
    tile_rows /= 2;
  }
  const size_t smem = wide_layout(a, tile_rows, resident);
  bool wide_frags = false;
  for (int l = 0; l < a.n_layers; ++l) wide_frags = wide_frags || a.layers[l].fw > 0;
  int per_sm = 0;
  err = resident ? (wide_frags ? wide_blocks_per_sm<true, true>(smem, &per_sm)
                               : wide_blocks_per_sm<true, false>(smem, &per_sm))
                 : (wide_frags ? wide_blocks_per_sm<false, true>(smem, &per_sm)
                               : wide_blocks_per_sm<false, false>(smem, &per_sm));
  if (err != cudaSuccess) return (int)err;
  a.tiles = (a.B + tile_rows - 1) / tile_rows;
  a.n_tiles = (long long)M * a.tiles;
  const long long resident_blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *plan = {resident, wide_frags, tile_rows, smem, per_sm,
           a.n_tiles < resident_blocks ? a.n_tiles : resident_blocks};
  return 0;
}

int launch_wide(Args& a, int M, cudaStream_t stream) {
  WidePlan p;
  const int status = wide_plan(a, M, &p);
  if (status != 0) return status;
  const unsigned grid = (unsigned)p.grid;
  if (p.resident) {
    if (p.wide_frags) {
      fleet_dense_wide_kernel<true, true><<<grid, kWideThreads, p.smem, stream>>>(a);
    } else {
      fleet_dense_wide_kernel<true, false><<<grid, kWideThreads, p.smem, stream>>>(a);
    }
  } else if (p.wide_frags) {
    fleet_dense_wide_kernel<false, true><<<grid, kWideThreads, p.smem, stream>>>(a);
  } else {
    fleet_dense_wide_kernel<false, false><<<grid, kWideThreads, p.smem, stream>>>(a);
  }
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
  // kernel too, and chip_smoke.py times it beside this one at the
  // hourglass(20) shapes ([narrow vs wide], PERF.md).
  if (max_width <= kNarrowWidth) return launch_narrow(a, M, s);
#endif
  return launch_wide(a, M, s);
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

// How the wide kernel would run M x B rows of a spec (dims as for
// fleet_dense_forward): resident (1) or streamed (0) weights, rows a tile,
// warps a 16-row slice, shared memory a block, blocks an SM and grid.
// Returns 0 or an error code as fleet_dense_forward does.
int fleet_dense_wide_occupancy(int n_layers, const int* dims, int M, int B, int* resident,
                               int* tile_rows, int* warps_a_slice, int* smem_bytes,
                               int* blocks_per_sm, int* grid) {
  if (n_layers < 1 || M < 1 || B < 1) return kBadShape;
  if (n_layers > kMaxLayers) return kTooManyLayers;
  Args a = {};
  a.B = B;
  a.F = dims[0];
  a.F_out = dims[n_layers];
  a.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return kBadShape;
    if (dims[l] > kMaxWidth) return kTooWide;
  }
  for (int l = 0; l < n_layers; ++l) {
    a.layers[l].d_in = dims[l];
    a.layers[l].d_out = dims[l + 1];
  }
  WidePlan p;
  const int status = wide_plan(a, M, &p);
  if (status != 0) return status;
  *resident = p.resident ? 1 : 0;
  *tile_rows = p.tile_rows;
  *warps_a_slice = 1 << a.wpr_shift;
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
