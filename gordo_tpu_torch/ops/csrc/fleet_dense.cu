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
// build serves every spec. One block per (member, tile of rows); the
// ragged last tile is masked, not padded. The block reads its member
// index and the params at that index itself, so no gathered copy of the
// bucket is ever made. Two kernels, chosen by the spec's widest layer:
//
// Narrow specs (every width <= kNarrowWidth = 32; the production
// hourglass is 20 wide): fleet_dense_narrow_kernel.
//   - One thread per row, kNarrowRows rows a block. All layers' weights
//     and biases (~6 KB for hourglass(20)) are staged into shared memory
//     once, as the TPU kernel keeps them in VMEM; then each thread walks
//     its row through every layer with the activations in registers: no
//     barrier and no shared-memory activation traffic between layers.
//   - Per k a thread reads one float4 of weights (the same address across
//     the warp, a broadcast) for 4 FMAs, four k at a time so that four
//     loads are in flight before their FMAs. Loops are unrolled to the
//     32-wide maximum and leave at the real width (rounded up to 4 with
//     zero-padded weights), so registers index statically and a 13-wide
//     layer costs 16 steps, not 32. The activation is applied in one pass
//     a layer, with the switch on its code outside the per-element loop.
//   - The row tile is read and written through shared memory so that the
//     device-memory traffic stays coalesced, and each thread's global
//     loads of the tile and the weights are issued together.
//
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
//     ingest prologue only read it), so y costs no second read.
//     Otherwise each thread reads its row of y from global memory.
//   - Wide kernel: the final store walks one row a warp, lanes striding
//     the row's columns; each lane sums its squares, a warp shuffle adds
//     them, and lane 0 writes the row's mse.
// Padded weight columns (narrow: widths rounded up to 4; wide: chunks)
// never enter the sum: it runs over the real columns j < w only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 32;
constexpr int kMaxWidth = 512;
constexpr int kNarrowWidth = 32;
constexpr int kNarrowRows = 128;
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
  int ldw;    // narrow kernel: d_out rounded up to 4, the staged row length
  int w_off;  // narrow kernel: offsets of the staged W and b, in floats
  int b_off;
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
  int ingest_off;       // narrow kernel: offset of the staged scale, offset
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

// The layer's activation over v[0:width), one switch a layer.
__device__ __forceinline__ void activate_layer(float (&v)[kNarrowWidth], int width, int act) {
  if (act == kSoftmax) {
    softmax_row(v, width);
    return;
  }
  with_activation(act, [&](auto code) {
#pragma unroll
    for (int j = 0; j < kNarrowWidth; ++j) {
      if (j >= width) break;
      v[j] = activate(v[j], decltype(code)::value);
    }
  });
}

// One layer of one row, registers to registers: out = act(in W + b).
// Staged W has its rows padded with zeros to a multiple of 4 and its
// columns to ldw; in[k] is exactly 0 for d_in <= k < ldw of the layer
// before, so the padded steps add exact zeros. out[j] is 0 for
// d_out <= j < ldw, and out[j] for j >= ldw is never read.
__device__ __forceinline__ void narrow_layer(const float (&in)[kNarrowWidth],
                                             float (&out)[kNarrowWidth],
                                             const float* smem, const Layer& L) {
  const float* w = smem + L.w_off;
  const float* bias = smem + L.b_off;
#pragma unroll
  for (int j = 0; j < kNarrowWidth; j += 4) {
    if (j >= L.d_out) break;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kNarrowWidth; k += 4) {
      if (k >= L.d_in) break;
      // four weight rows in flight before their 16 FMAs; k stays in order
      float4 wv[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) wv[s] = *reinterpret_cast<const float4*>(w + (k + s) * L.ldw + j);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        acc.x = fmaf(in[k + s], wv[s].x, acc.x);
        acc.y = fmaf(in[k + s], wv[s].y, acc.y);
        acc.z = fmaf(in[k + s], wv[s].z, acc.z);
        acc.w = fmaf(in[k + s], wv[s].w, acc.w);
      }
    }
    const float4 bv = *reinterpret_cast<const float4*>(bias + j);
    out[j + 0] = acc.x + bv.x;
    out[j + 1] = j + 1 < L.d_out ? acc.y + bv.y : 0.f;
    out[j + 2] = j + 2 < L.d_out ? acc.z + bv.z : 0.f;
    out[j + 3] = j + 3 < L.d_out ? acc.w + bv.w : 0.f;
  }
  activate_layer(out, L.d_out, L.act);
}

// n floats from global src to shared dst, a thread's loads in flight
// together (float4 when both ends allow it).
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    const float4* s = reinterpret_cast<const float4*>(src);
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d[i] = __ldg(s + i);
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
  }
}

// n floats from shared src to global dst.
__device__ __forceinline__ void store_tile(float* dst, const float* src, int n) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (n & 3) == 0) {
    const float4* s = reinterpret_cast<const float4*>(src);
    float4* d = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kNarrowRows)
    fleet_dense_narrow_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* io = smem;  // the row tile, [rows][F] in, then [rows][F_out] out

  const int m = blockIdx.x / a.tiles;
  const int tile = blockIdx.x - m * a.tiles;
  const int row0 = tile * kNarrowRows;
  const int rows = min(kNarrowRows, a.B - row0);
  const int n = a.indices[m];

  // Stage every layer's W, zero-padded to [ceil4(d_in)][ldw], and b.
  for (int l = 0; l < a.n_layers; ++l) {
    const Layer& L = a.layers[l];
    const float* __restrict__ W = L.W + (size_t)n * L.d_in * L.d_out;
    float* w = smem + L.w_off;
    const int count = (L.d_in + 3) / 4 * 4 * L.ldw;
#pragma unroll 4
    for (int i = threadIdx.x; i < count; i += kNarrowRows) {
      const int k = i / L.ldw;
      const int j = i - k * L.ldw;
      w[i] = k < L.d_in && j < L.d_out ? __ldg(W + k * L.d_out + j) : 0.f;
    }
    if (threadIdx.x < L.ldw) {
      smem[L.b_off + threadIdx.x] =
          threadIdx.x < L.d_out ? __ldg(L.b + (size_t)n * L.d_out + threadIdx.x) : 0.f;
    }
  }
  float* sc = smem + a.ingest_off;
  float* of = sc + kNarrowWidth;
  if (a.scale && threadIdx.x < a.F) {
    sc[threadIdx.x] = __ldg(a.scale + (size_t)n * a.F + threadIdx.x);
    of[threadIdx.x] = __ldg(a.offset + (size_t)n * a.F + threadIdx.x);
  }
  load_tile(io, a.X + ((size_t)m * a.B + row0) * a.F, rows * a.F);
  __syncthreads();

  const int r = threadIdx.x;
  float h[kNarrowWidth], t[kNarrowWidth];
#pragma unroll
  for (int k = 0; k < kNarrowWidth; ++k) {
    h[k] = 0.f;
    t[k] = 0.f;
  }
  if (r < rows) {
#pragma unroll
    for (int k = 0; k < kNarrowWidth; ++k) {
      if (k >= a.F) break;
      float v = io[r * a.F + k];
      // multiply then add, each rounded, as the plain version does
      if (a.scale) v = __fadd_rn(__fmul_rn(v, sc[k]), of[k]);
      h[k] = v;
    }
  }

  for (int l = 0; l < a.n_layers; ++l) {
    narrow_layer(h, t, smem, a.layers[l]);
#pragma unroll
    for (int k = 0; k < kNarrowWidth; ++k) h[k] = t[k];
  }

  if (a.mse && r < rows) {
    // K2's epilogue, before io is overwritten: y = X is the raw row in io
    const float* y = a.y == a.X ? io + r * a.F : a.y + ((size_t)m * a.B + row0 + r) * a.F_y;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kNarrowWidth; ++j) {
      if (j >= a.w) break;
      const float d = h[j] - y[j];
      sum = fmaf(d, d, sum);
    }
    a.mse[(size_t)m * a.B + row0 + r] = sum / (float)a.w;
  }

  __syncthreads();  // every thread has read its input row out of io
  if (r < rows) {
    float* row = io + r * a.F_out;
#pragma unroll
    for (int j = 0; j < kNarrowWidth; ++j) {
      if (j >= a.F_out) break;
      row[j] = h[j];
    }
  }
  __syncthreads();
  store_tile(a.out + ((size_t)m * a.B + row0) * a.F_out, io, rows * a.F_out);
}

// cp.async (sm_80 and later): a 4-byte global-to-shared copy that does
// not stall the thread; with valid false it writes a zero and reads
// nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

int launch_narrow(Args& a, int M, cudaStream_t stream) {
  // shared memory: the row tile, the ingest vectors, then each layer's W
  // and b; every region starts 16-byte aligned for float4 loads
  int off = kNarrowRows * (a.F > a.F_out ? a.F : a.F_out);
  off = (off + 3) / 4 * 4;
  a.ingest_off = off;
  off += 2 * kNarrowWidth;
  for (int l = 0; l < a.n_layers; ++l) {
    Layer& L = a.layers[l];
    L.ldw = (L.d_out + 3) / 4 * 4;
    L.w_off = off;
    off += (L.d_in + 3) / 4 * 4 * L.ldw;
    L.b_off = off;
    off += L.ldw;
  }
  const size_t smem = (size_t)off * sizeof(float);  // <= 152 KB at 32 layers
  a.tiles = (a.B + kNarrowRows - 1) / kNarrowRows;
  cudaError_t err = cudaFuncSetAttribute(
      fleet_dense_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)M * a.tiles;
  if (blocks > 0x7fffffffLL) return kBadShape;
  fleet_dense_narrow_kernel<<<(unsigned)blocks, kNarrowRows, smem, stream>>>(a);
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
  // wide kernel takes 2.9x the narrow one's time on hourglass(20) at
  // 1000 x 1008 rows and 2.6x at 64 x 1008, and is level at 1 x 1008.
  if (max_width <= kNarrowWidth) return launch_narrow(a, M, s);
#endif
  // 16 warps a block beat 8 on feedforward_model's 256-wide layers and
  // lose on a 40-wide hourglass, whose narrow layers leave most idle
  if (max_width <= 128) return launch_wide<64, 256>(a, M, max_width, s);
  if (max_width <= 256) return launch_wide<64, 512>(a, M, max_width, s);
  return launch_wide<32, 512>(a, M, max_width, s);
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
