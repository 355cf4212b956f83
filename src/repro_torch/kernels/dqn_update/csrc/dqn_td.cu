// Fused double-DQN TD update for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/dqn_update/kernel.py  _td_kernel (body, line 73),
//   launched by dqn_td_pallas through pl.pallas_call (line 218).
// One launch computes, for a replay batch of B rows:
//   1. EvalNet forward on s (D -> 256 -> 64 -> A, ReLU), keeping h1/h2;
//   2. the double-DQN target: first-max argmax of EvalNet(s'), TargNet
//      values that action, y = r + gamma * (1 - done) * q_tn;
//   3. the Huber TD loss (delta 1), divided by the true B;
//   4. the hand-derived backward (relu' is 0 at z == 0, as jax.nn.relu);
//   5. the global-norm clip at 10;
//   6. either the clipped gradients (FOLD_ADAM = false, the grads variant)
//      or Adam folded in (FOLD_ADAM = true: beta 0.9/0.999, eps 1e-8,
//      bias corrections from step + 1).
//
// Design.  One thread block of 512 threads does the whole update: the
// Pallas grid's sequential batch axis becomes a loop over row tiles of
// BT = 16 inside the block, so the gradient sums and the global norm need
// no cross-block reduction.  Weights are read from global memory (both
// nets, 2 x 32,267 floats at the path's widths, stay in the 50 MB L2).
// The gradient accumulators and one row tile of activations live in
// shared memory; every accumulator element is owned by one thread (no
// atomics), so the result does not depend on scheduling.  Rows past B are
// loaded as zeros and get err = 0, so they contribute exactly zero.
//
// Shared-memory budget (floats), D = 3 + 5n, A = n:
//   gradient accumulators  P = D*256 + 256 + 256*64 + 64 + 64*A + A
//   s, s' tiles            2 * BT * D
//   h1 and its scratch     2 * BT * 256   (the scratch holds dh1)
//   h2, scratch, dh2       3 * BT * 64
//   q, q_e(s'), q_t(s'), dq  4 * BT * A
//   per-row g and action   2 * BT, reduction slots 33
// At n = 11 (D = 58, A = 11) that is 46,156 floats = 184,624 bytes of the
// 232,448 a block may use; dqn_td_smem_bytes() reports it per shape.
//
// Bound on the H100 at B = 64 (n = 11): the update reads eval, targ, mu
// and nu and writes params, mu and nu, about 0.93 MB, 0.28 us at
// 3.35 TB/s; it does about 18.5 MFLOP, 0.28 us at 67 TFLOP/s fp32.  One
// block on one SM is far from either, and from the launch latency too:
// that SM serialises the ~9.2 M FMAs and waits on L2 for the weights in
// every inner loop (0.37 ms on an H100 SXM at 700 W, chip_smoke.py).
// Making it fast (a cluster or multi-block split of the row tiles and of
// the weight columns, wgmma for the products) is later work.  TF32 tensor cores are not used: they keep about three
// decimal digits, and the reference tolerance is 1e-5.

#include <cuda_runtime.h>

namespace {

constexpr int H1 = 256;
constexpr int H2 = 64;
constexpr int BT = 16;
constexpr int THREADS = 512;
constexpr float GRAD_CLIP = 10.0f;
constexpr float ADAM_B1 = 0.9f;
constexpr float ADAM_B2 = 0.999f;
constexpr float ADAM_EPS = 1e-8f;
// (1 - beta) as the reference rounds it: in double, then to f32
constexpr float ONE_MINUS_B1 = (float)(1.0 - 0.9);
constexpr float ONE_MINUS_B2 = (float)(1.0 - 0.999);

static_assert(THREADS % H1 == 0 && BT % (THREADS / H1) == 0, "tiling");
static_assert(THREADS % H2 == 0 && BT % (THREADS / H2) == 0, "tiling");

struct Net {
  const float* p[6];  // w1 [D,H1], b1 [H1], w2 [H1,H2], b2 [H2], w3 [H2,A], b3 [A]
};

struct Args {
  const float* s;
  const int* a;
  const float* r;
  const float* sn;
  const float* done;
  Net eval, targ, mu, nu;
  const int* step;
  float* loss;
  float* out[6];    // grads, or new params
  float* out_m[6];
  float* out_v[6];
  int B, D, A;
  float gamma, lr;
};

__host__ __device__ inline int n_params(int D, int A) {
  return D * H1 + H1 + H1 * H2 + H2 + H2 * A + A;
}

__host__ __device__ inline int smem_floats(int D, int A) {
  return n_params(D, A) + 2 * BT * D + 2 * BT * H1 + 3 * BT * H2 +
         4 * BT * A + 2 * BT + 33;
}

// y[r, :] = MLP(x[r, :]) for the BT rows of a tile; h1o/h2o keep the
// post-ReLU activations (h > 0 iff z > 0, so they double as relu' masks).
__device__ void forward(const Net& w, const float* x, int D, int A,
                        float* h1o, float* h2o, float* qo) {
  const int t = threadIdx.x;
  {
    constexpr int RG = THREADS / H1, RPT = BT / RG;
    const int j = t % H1, rg = t / H1;
    float acc[RPT];
#pragma unroll
    for (int m = 0; m < RPT; ++m) acc[m] = 0.f;
    for (int k = 0; k < D; ++k) {
      const float wk = __ldg(&w.p[0][k * H1 + j]);
#pragma unroll
      for (int m = 0; m < RPT; ++m)
        acc[m] = fmaf(x[(rg + RG * m) * D + k], wk, acc[m]);
    }
    const float bj = __ldg(&w.p[1][j]);
#pragma unroll
    for (int m = 0; m < RPT; ++m)
      h1o[(rg + RG * m) * H1 + j] = fmaxf(acc[m] + bj, 0.f);
  }
  __syncthreads();
  {
    constexpr int RG = THREADS / H2, RPT = BT / RG;
    const int j = t % H2, rg = t / H2;
    float acc[RPT];
#pragma unroll
    for (int m = 0; m < RPT; ++m) acc[m] = 0.f;
    for (int k = 0; k < H1; ++k) {
      const float wk = __ldg(&w.p[2][k * H2 + j]);
#pragma unroll
      for (int m = 0; m < RPT; ++m)
        acc[m] = fmaf(h1o[(rg + RG * m) * H1 + k], wk, acc[m]);
    }
    const float bj = __ldg(&w.p[3][j]);
#pragma unroll
    for (int m = 0; m < RPT; ++m)
      h2o[(rg + RG * m) * H2 + j] = fmaxf(acc[m] + bj, 0.f);
  }
  __syncthreads();
  for (int e = t; e < BT * A; e += THREADS) {
    const int r = e / A, c = e % A;
    float acc = 0.f;
    for (int k = 0; k < H2; ++k)
      acc = fmaf(h2o[r * H2 + k], __ldg(&w.p[4][k * A + c]), acc);
    qo[e] = acc + __ldg(&w.p[5][c]);
  }
  __syncthreads();
}

// Sum of v over the block; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) s += red[i];
    red[32] = s;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();  // red may be reused by the next call
  return total;
}

template <bool FOLD_ADAM>
__global__ void __launch_bounds__(THREADS, 1) dqn_td_kernel(Args g) {
  extern __shared__ float sm[];
  const int D = g.D, A = g.A, B = g.B, t = threadIdx.x;
  const int size[6] = {D * H1, H1, H1 * H2, H2, H2 * A, A};
  int off[6];
  off[0] = 0;
  for (int i = 1; i < 6; ++i) off[i] = off[i - 1] + size[i - 1];
  const int P = off[5] + size[5];

  float* gacc = sm;
  float* ts = gacc + P;        // s tile   [BT, D]
  float* tsn = ts + BT * D;    // s' tile  [BT, D]
  float* h1 = tsn + BT * D;    // EvalNet(s) h1 [BT, H1]
  float* x1 = h1 + BT * H1;    // scratch h1 for s', then dh1
  float* h2 = x1 + BT * H1;    // EvalNet(s) h2 [BT, H2]
  float* x2 = h2 + BT * H2;    // scratch h2 for s'
  float* dh2 = x2 + BT * H2;
  float* q = dh2 + BT * H2;    // EvalNet(s)  [BT, A]
  float* qe = q + BT * A;      // EvalNet(s')
  float* qt = qe + BT * A;     // TargNet(s')
  float* dq = qt + BT * A;
  float* rowg = dq + BT * A;   // dL/dq_sel per row
  int* rowa = reinterpret_cast<int*>(rowg + BT);
  float* red = rowg + 2 * BT;  // 33 reduction slots

  for (int e = t; e < P; e += THREADS) gacc[e] = 0.f;
  float lsum = 0.f;  // Huber sum of this thread's rows (t < BT)

  for (int r0 = 0; r0 < B; r0 += BT) {
    const int rows = min(BT, B - r0);
    for (int e = t; e < BT * D; e += THREADS) {
      const bool in = e < rows * D;
      ts[e] = in ? g.s[(size_t)r0 * D + e] : 0.f;
      tsn[e] = in ? g.sn[(size_t)r0 * D + e] : 0.f;
    }
    __syncthreads();
    forward(g.eval, ts, D, A, h1, h2, q);
    forward(g.eval, tsn, D, A, x1, x2, qe);
    forward(g.targ, tsn, D, A, x1, x2, qt);

    if (t < BT) {
      float gr = 0.f;
      int ar = -1;
      if (t < rows) {
        const int r = r0 + t;
        int best = 0;
        float bv = qe[t * A];
        for (int c = 1; c < A; ++c) {
          const float v = qe[t * A + c];
          if (v > bv) { bv = v; best = c; }  // first max wins ties
        }
        const float q_tn = qt[t * A + best];
        ar = g.a[r];
        // an action outside [0, A) selects nothing, as the Pallas
        // kernel's one-hot does
        const float q_sel = (ar >= 0 && ar < A) ? q[t * A + ar] : 0.f;
        const float y = g.r[r] + g.gamma * (1.f - g.done[r]) * q_tn;
        const float err = y - q_sel;
        const float abse = fabsf(err);
        lsum += abse <= 1.f ? 0.5f * err * err : abse - 0.5f;
        gr = -fminf(fmaxf(err, -1.f), 1.f) / (float)B;
      }
      for (int c = 0; c < A; ++c) dq[t * A + c] = (c == ar) ? gr : 0.f;
      rowg[t] = gr;
      rowa[t] = ar;
    }
    __syncthreads();

    // dh2 = (dq W3^T) * [z2 > 0]; dq has one nonzero per row
    for (int e = t; e < BT * H2; e += THREADS) {
      const int rr = e / H2, j = e % H2, ar = rowa[rr];
      float v = 0.f;
      if (ar >= 0 && ar < A && h2[e] > 0.f)
        v = rowg[rr] * __ldg(&g.eval.p[4][j * A + ar]);
      dh2[e] = v;
    }
    __syncthreads();
    // dh1 = (dh2 W2^T) * [z1 > 0], into x1
    {
      constexpr int RG = THREADS / H1, RPT = BT / RG;
      const int i = t % H1, rg = t / H1;
      float acc[RPT];
#pragma unroll
      for (int m = 0; m < RPT; ++m) acc[m] = 0.f;
      for (int j = 0; j < H2; ++j) {
        const float wij = __ldg(&g.eval.p[2][i * H2 + j]);
#pragma unroll
        for (int m = 0; m < RPT; ++m)
          acc[m] = fmaf(dh2[(rg + RG * m) * H2 + j], wij, acc[m]);
      }
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int e = (rg + RG * m) * H1 + i;
        x1[e] = h1[e] > 0.f ? acc[m] : 0.f;
      }
    }
    __syncthreads();

    // gradient sums over the tile's rows, each element owned by one thread
    for (int e = t; e < size[0]; e += THREADS) {  // dW1 = s^T dh1
      const int k = e / H1, i = e % H1;
      float acc = gacc[off[0] + e];
      for (int rr = 0; rr < BT; ++rr)
        acc = fmaf(ts[rr * D + k], x1[rr * H1 + i], acc);
      gacc[off[0] + e] = acc;
    }
    for (int i = t; i < H1; i += THREADS) {  // db1
      float acc = gacc[off[1] + i];
      for (int rr = 0; rr < BT; ++rr) acc += x1[rr * H1 + i];
      gacc[off[1] + i] = acc;
    }
    for (int e = t; e < size[2]; e += THREADS) {  // dW2 = h1^T dh2
      const int i = e / H2, j = e % H2;
      float acc = gacc[off[2] + e];
      for (int rr = 0; rr < BT; ++rr)
        acc = fmaf(h1[rr * H1 + i], dh2[rr * H2 + j], acc);
      gacc[off[2] + e] = acc;
    }
    for (int j = t; j < H2; j += THREADS) {  // db2
      float acc = gacc[off[3] + j];
      for (int rr = 0; rr < BT; ++rr) acc += dh2[rr * H2 + j];
      gacc[off[3] + j] = acc;
    }
    for (int e = t; e < size[4]; e += THREADS) {  // dW3 = h2^T dq
      const int j = e / A, c = e % A;
      float acc = gacc[off[4] + e];
      for (int rr = 0; rr < BT; ++rr)
        acc = fmaf(h2[rr * H2 + j], dq[rr * A + c], acc);
      gacc[off[4] + e] = acc;
    }
    for (int c = t; c < A; c += THREADS) {  // db3
      float acc = gacc[off[5] + c];
      for (int rr = 0; rr < BT; ++rr) acc += dq[rr * A + c];
      gacc[off[5] + c] = acc;
    }
    __syncthreads();
  }

  const float loss_sum = block_sum(lsum, red);
  float sq = 0.f;
  for (int e = t; e < P; e += THREADS) sq = fmaf(gacc[e], gacc[e], sq);
  const float gnorm = sqrtf(block_sum(sq, red));
  const float clip = fminf(1.f, GRAD_CLIP / fmaxf(gnorm, 1e-9f));
  if (t == 0) g.loss[0] = loss_sum / (float)B;

  float c1 = 0.f, c2 = 0.f;
  if (FOLD_ADAM) {
    const float stepf = (float)(g.step[0] + 1);
    c1 = 1.f - powf(ADAM_B1, stepf);
    c2 = 1.f - powf(ADAM_B2, stepf);
  }
  for (int s = 0; s < 6; ++s) {
    for (int e = t; e < size[s]; e += THREADS) {
      const float gg = gacc[off[s] + e] * clip;
      if (!FOLD_ADAM) {
        g.out[s][e] = gg;
      } else {
        const float m = ADAM_B1 * g.mu.p[s][e] + ONE_MINUS_B1 * gg;
        const float v = ADAM_B2 * g.nu.p[s][e] + ONE_MINUS_B2 * gg * gg;
        g.out_m[s][e] = m;
        g.out_v[s][e] = v;
        g.out[s][e] =
            g.eval.p[s][e] - g.lr * (m / c1) / (sqrtf(v / c2) + ADAM_EPS);
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs at widths (D, A).
int dqn_td_smem_bytes(int D, int A) {
  return smem_floats(D, A) * (int)sizeof(float);
}

const char* dqn_td_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ptrs holds, in order: s, a, r, s', done, eval[6], targ[6], mu[6], nu[6],
// step, loss, out[6], out_m[6], out_v[6]  (49 device pointers; mu, nu,
// step, out_m and out_v are null for the grads variant).  Launches on
// `stream` and returns the launch's CUDA error code (0 on success).
int dqn_td_launch(void* const* ptrs, int B, int D, int A, float gamma,
                  float lr, int fold_adam, void* stream) {
  if (B < 1 || D < 1 || A < 1) return (int)cudaErrorInvalidValue;
  Args g;
  int k = 0;
  g.s = static_cast<const float*>(ptrs[k++]);
  g.a = static_cast<const int*>(ptrs[k++]);
  g.r = static_cast<const float*>(ptrs[k++]);
  g.sn = static_cast<const float*>(ptrs[k++]);
  g.done = static_cast<const float*>(ptrs[k++]);
  Net* nets[4] = {&g.eval, &g.targ, &g.mu, &g.nu};
  for (Net* net : nets)
    for (int i = 0; i < 6; ++i) net->p[i] = static_cast<const float*>(ptrs[k++]);
  g.step = static_cast<const int*>(ptrs[k++]);
  g.loss = static_cast<float*>(ptrs[k++]);
  for (int i = 0; i < 6; ++i) g.out[i] = static_cast<float*>(ptrs[k++]);
  for (int i = 0; i < 6; ++i) g.out_m[i] = static_cast<float*>(ptrs[k++]);
  for (int i = 0; i < 6; ++i) g.out_v[i] = static_cast<float*>(ptrs[k++]);
  g.B = B;
  g.D = D;
  g.A = A;
  g.gamma = gamma;
  g.lr = lr;

  const int smem = dqn_td_smem_bytes(D, A);
  auto kern = fold_adam ? dqn_td_kernel<true> : dqn_td_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
