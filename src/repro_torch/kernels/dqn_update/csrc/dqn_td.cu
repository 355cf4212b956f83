// Fused double-DQN TD update for Hopper (sm_90a): a thread-block cluster,
// fp32 on CUDA cores.
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
// What the TPU kernel was: one core with the two nets resident in VMEM and
// the batch streamed through a sequential grid of row tiles, the gradient
// sums carried in VMEM scratch from tile to tile.
//
// What bounds the card: at the path's widths (n = 11: D = 58, A = 11) and
// B = 64 an update is ~9.2 M FMAs and ~0.93 MB of weights, moments and
// outputs: 0.28 us at 67 TFLOP/s fp32 or at 3.35 TB/s.  Neither is reached
// by a launch that fits in a few microseconds; what costs is latency: a
// weight read from L2 in every inner-loop step, barriers, and the FMAs
// serialised on too few SMs.  The first port ran the whole update in one
// 512-thread block on one SM, streaming 16-row tiles (0.37 ms).
//
// Design: a cluster of CL = 8 blocks (the portable cluster size) on
// neighbouring SMs, sharing work through distributed shared memory (DSMEM).
//  * Rank r owns layer-1 units [32r, 32r + 32): those columns of W1 and b1
//    and those rows of W2, for both nets, copied once into its shared
//    memory by cp.async together with up to BT = 64 rows of s and s'.  At
//    B <= 64 a launch is one pass; a larger B loops over 64-row passes
//    inside the cluster, the gradient sums carried in shared memory.
//  * Layer 1 (three forwards: eval on s, eval on s', targ on s') is local
//    to each rank; each rank then forms its partial layer-2 sums z2 [64, 64]
//    over its 32 units.  After a cluster barrier, rank r adds the partials
//    of the 8 ranks, in rank order (no atomics), for its 8 rows of the
//    pass, and finishes those rows' head: h2, the 3 x A Q values, the
//    first-max argmax, y, the Huber loss, g and dh2.
//  * A second barrier, then every rank gathers dh2 [64, 64] (and h2, g and
//    the action of each row) from the rows' owners.  dh1 for its units,
//    dW1 / db1 for its columns and dW2 for its rows are local; rank r also
//    owns dW3 rows and b2 entries [8r, 8r + 8), and rank 0 owns db3.
//  * The global-norm clip adds each rank's sum of squares (and Huber sum)
//    across the cluster in rank order; every rank then emits, or applies
//    Adam to, the slices it owns.
// Lanes: a launch of L lanes is a grid of L clusters, cluster l computing
// lane l's update from its own batch [l] (s, a, r, s', done are [L, B, ...]).
// Under jax.vmap the Pallas call gains a leading lane grid axis in the same
// way: the data-parallel trainer vmaps the grads variant over per-lane
// batches with the nets shared, the population trainer vmaps the Adam
// variant over per-lane nets, moments and steps.  Shared nets are read
// with lane stride 0, never copied L times; outputs are [L, ...].  A lane
// runs exactly the single-lane code on its own pointers, so L = 1 is the
// single-lane launch and gives its bits.  A block takes 202,368 B of shared
// memory at n = 11, so one block fits an SM and L clusters need 8L SMs;
// clusters beyond what the card holds at once queue
// (dqn_td_max_active_clusters()).
//
// Every accumulator element is owned by one thread and every sum runs in a
// fixed order, so two calls give the same bits.  Rows past B load as zeros
// and get g = 0, so they add exactly zero.  Each rank does 1/8 of the FMAs
// with its weights in shared memory; TF32 tensor cores are not used (they
// keep about three decimal digits, the reference tolerance is 1e-5).
//
// Shared memory per block (floats, each region rounded up to 4), D = 3 + 5n,
// A = n: weight slices 2 (32D + 32 + 32 x 68 + 64 + 64A + A); s, s' 2 x 68 D;
// h1 3 x 32 x 68; z2 partials 3 x 64 x 64; head scratch 8 (3 x 64 + 3A + 2 x
// 64 + 3); gathered dh2 64 x 68, h2 64 x 8, g and action 2 x 64; dh1 64 x 36;
// owned gradient sums 32D + 32 + 32 x 64 + 8 + 8A + A; 12 reduction slots.
// At n = 11 that is 202,368 bytes of the 232,448 a block may use (n <= 16
// fits); dqn_td_smem_bytes() reports it per shape.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int H1 = 256;
constexpr int H2 = 64;
constexpr int CL = 8;              // blocks of the cluster
constexpr int HC = H1 / CL;        // layer-1 units a rank owns
constexpr int JR = H2 / CL;        // layer-2 units a rank owns (W3 rows, b2)
constexpr int BT = 64;             // batch rows a pass
constexpr int RPR = BT / CL;       // rows of a pass whose head a rank finishes
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LDW2 = H2 + 4;       // row stride of the W2 slices and gathered dh2
constexpr int LDS = BT + 4;        // row stride of s^T, s'^T and h1^T
constexpr int LDD = HC + 4;        // row stride of dh1
constexpr float GRAD_CLIP = 10.0f;
constexpr float ADAM_B1 = 0.9f;
constexpr float ADAM_B2 = 0.999f;
constexpr float ADAM_EPS = 1e-8f;
// (1 - beta) as the reference rounds it: in double, then to f32
constexpr float ONE_MINUS_B1 = (float)(1.0 - 0.9);
constexpr float ONE_MINUS_B2 = (float)(1.0 - 0.999);

static_assert(RPR == WARPS, "one warp per head row");
static_assert(THREADS == 8 * 32 && HC == 32 && BT == 64 && H2 == 64,
              "the thread maps below assume these widths");

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
  int lane_eval;    // eval (and its Adam outputs' base) has a lane axis
  int lane_targ;    // targ has a lane axis
  unsigned vec;     // bit i (eval) / 6 + i (targ): parameter i is 16-byte
                    // aligned in every lane
};

// Lane `lane`'s view of the launch: its batch rows, its nets (or the shared
// ones), its moments, step, loss and outputs.
__device__ __forceinline__ Args lane_args(const Args& g0, int lane) {
  Args g = g0;
  if (lane == 0) return g;
  const size_t l = static_cast<size_t>(lane);
  const size_t rows = l * static_cast<size_t>(g.B);
  const size_t D = g.D, A = g.A;
  const size_t sz[6] = {D * H1, H1, static_cast<size_t>(H1) * H2, H2,
                        H2 * A, A};
  g.s += rows * D;
  g.sn += rows * D;
  g.a += rows;
  g.r += rows;
  g.done += rows;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (g.lane_eval) g.eval.p[i] += l * sz[i];
    if (g.lane_targ) g.targ.p[i] += l * sz[i];
    if (g.mu.p[i]) g.mu.p[i] += l * sz[i];
    if (g.nu.p[i]) g.nu.p[i] += l * sz[i];
    g.out[i] += l * sz[i];
    if (g.out_m[i]) g.out_m[i] += l * sz[i];
    if (g.out_v[i]) g.out_v[i] += l * sz[i];
  }
  if (g.step) g.step += l;
  g.loss += l;
  return g;
}

// Offsets (floats) of the shared-memory regions; the same on host and card.
struct Layout {
  int w1e, w1t, b1e, b1t, w2e, w2t, b2e, b2t, w3e, w3t, b3e, b3t;
  int st, snt, h1t, z2p, h2w, qs, h2o, dh2o, rowo;
  int dh2f, h2f, gf, af, dh1;
  int gw1, gb1, gw2, gb2, gw3, gb3, red, total;
};

__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o += (n + 3) & ~3;
  return at;
}

__host__ __device__ inline Layout layout(int D, int A) {
  Layout L;
  int o = 0;
  L.w1e = take(o, D * HC);  L.w1t = take(o, D * HC);
  L.b1e = take(o, HC);      L.b1t = take(o, HC);
  L.w2e = take(o, HC * LDW2); L.w2t = take(o, HC * LDW2);
  L.b2e = take(o, H2);      L.b2t = take(o, H2);
  L.w3e = take(o, H2 * A);  L.w3t = take(o, H2 * A);
  L.b3e = take(o, A);       L.b3t = take(o, A);
  L.st = take(o, D * LDS);  L.snt = take(o, D * LDS);
  L.h1t = take(o, 3 * HC * LDS);
  L.z2p = take(o, 3 * BT * H2);
  L.h2w = take(o, RPR * 3 * H2);
  L.qs = take(o, RPR * 3 * A);
  L.h2o = take(o, RPR * H2);
  L.dh2o = take(o, RPR * H2);
  L.rowo = take(o, 3 * RPR);  // g, action (as int bits), Huber of own rows
  L.dh2f = take(o, BT * LDW2);
  L.h2f = take(o, BT * JR);
  L.gf = take(o, BT);
  L.af = take(o, BT);
  L.dh1 = take(o, BT * LDD);
  L.gw1 = take(o, D * HC);
  L.gb1 = take(o, HC);
  L.gw2 = take(o, HC * H2);
  L.gb2 = take(o, JR);
  L.gw3 = take(o, JR * A);
  L.gb3 = take(o, A);
  L.red = take(o, WARPS + 4);
  L.total = o;
  return L;
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// rows x cols floats from src (row stride sld) to dst (row stride dld), by
// 16-byte copies where cols, strides and pointers allow it
__device__ void copy_rows(float* dst, int dld, const float* src, int sld,
                          int rows, int cols, bool vec) {
  if (vec && cols % 4 == 0 && sld % 4 == 0 && dld % 4 == 0) {
    const int c4 = cols / 4;
    for (int e = threadIdx.x; e < rows * c4; e += THREADS) {
      const int i = e / c4, j = e % c4;
      cp16(dst + i * dld + j * 4, src + static_cast<size_t>(i) * sld + j * 4);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int i = e / cols, j = e % cols;
      cp4(dst + i * dld + j, src + static_cast<size_t>(i) * sld + j, true);
    }
  }
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Sum of v over the block in a fixed order; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < WARPS; ++i) s += red[i];
    red[WARPS] = s;
  }
  __syncthreads();
  const float total = red[WARPS];
  __syncthreads();  // red may be reused
  return total;
}

template <bool FOLD_ADAM>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 1)
    dqn_td_kernel(Args g_all) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rk = static_cast<int>(cluster.block_rank());
  const Args g = lane_args(g_all, static_cast<int>(blockIdx.x) / CL);
  const int D = g.D, A = g.A, B = g.B, t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  auto vec = [&](int net, int i) { return ((g.vec >> (net * 6 + i)) & 1u) != 0; };
  const Layout L = layout(D, A);
  float* W1E = sm + L.w1e; float* W1T = sm + L.w1t;
  float* B1E = sm + L.b1e; float* B1T = sm + L.b1t;
  float* W2E = sm + L.w2e; float* W2T = sm + L.w2t;
  float* B2E = sm + L.b2e; float* B2T = sm + L.b2t;
  float* W3E = sm + L.w3e; float* W3T = sm + L.w3t;
  float* B3E = sm + L.b3e; float* B3T = sm + L.b3t;
  float* ST = sm + L.st;   float* SNT = sm + L.snt;   // [k][row], stride LDS
  float* H1T = sm + L.h1t;   // [forward][unit][row]: eval(s), eval(s'), targ(s')
  float* Z2P = sm + L.z2p;   // [forward][row][j] partial layer-2 sums
  float* H2W = sm + L.h2w;   // [own row][forward][j]
  float* QS = sm + L.qs;     // [own row][forward][action]
  float* H2O = sm + L.h2o;   // [own row][j] eval h2 on s
  float* DH2O = sm + L.dh2o; // [own row][j]
  float* ROWO = sm + L.rowo; // g [RPR], action [RPR], Huber [RPR]
  float* DH2F = sm + L.dh2f; // [row][j], stride LDW2, gathered
  float* H2F = sm + L.h2f;   // [row][j - JR rk]
  float* GF = sm + L.gf;
  int* AF = reinterpret_cast<int*>(sm + L.af);
  float* DH1 = sm + L.dh1;   // [row][unit], stride LDD
  float* GW1 = sm + L.gw1; float* GB1 = sm + L.gb1; float* GW2 = sm + L.gw2;
  float* GB2 = sm + L.gb2; float* GW3 = sm + L.gw3; float* GB3 = sm + L.gb3;
  float* RED = sm + L.red;

  // this rank's slices of both nets, once
  copy_rows(W1E, HC, g.eval.p[0] + rk * HC, H1, D, HC, vec(0, 0));
  copy_rows(W1T, HC, g.targ.p[0] + rk * HC, H1, D, HC, vec(1, 0));
  copy_rows(B1E, HC, g.eval.p[1] + rk * HC, HC, 1, HC, vec(0, 1));
  copy_rows(B1T, HC, g.targ.p[1] + rk * HC, HC, 1, HC, vec(1, 1));
  copy_rows(W2E, LDW2, g.eval.p[2] + rk * HC * H2, H2, HC, H2, vec(0, 2));
  copy_rows(W2T, LDW2, g.targ.p[2] + rk * HC * H2, H2, HC, H2, vec(1, 2));
  copy_rows(B2E, H2, g.eval.p[3], H2, 1, H2, vec(0, 3));
  copy_rows(B2T, H2, g.targ.p[3], H2, 1, H2, vec(1, 3));
  copy_rows(W3E, H2 * A, g.eval.p[4], H2 * A, 1, H2 * A, vec(0, 4));
  copy_rows(W3T, H2 * A, g.targ.p[4], H2 * A, 1, H2 * A, vec(1, 4));
  copy_rows(B3E, A, g.eval.p[5], A, 1, A, vec(0, 5));
  copy_rows(B3T, A, g.targ.p[5], A, 1, A, vec(1, 5));
  for (int e = t; e < D * HC; e += THREADS) GW1[e] = 0.f;
  for (int e = t; e < HC * H2; e += THREADS) GW2[e] = 0.f;
  for (int e = t; e < JR * A; e += THREADS) GW3[e] = 0.f;
  if (t < HC) GB1[t] = 0.f;
  if (t < JR) GB2[t] = 0.f;
  if (t < A) GB3[t] = 0.f;
  float lsum = 0.f;  // Huber sum of this rank's rows (thread 0)

  for (int r0 = 0; r0 < B; r0 += BT) {
    // s and s' rows of the pass, transposed; rows past B are zeros
    for (int e = t; e < BT * D; e += THREADS) {
      const int row = e / D, k = e % D;
      const bool in = r0 + row < B;
      const size_t at = in ? static_cast<size_t>(r0 + row) * D + k : 0;
      cp4(&ST[k * LDS + row], g.s + at, in);
      cp4(&SNT[k * LDS + row], g.sn + at, in);
    }
    cp_wait_all();

    // layer 1 for this rank's units: 2 rows x 4 units x 3 forwards a thread
    {
      const int c4 = t % 8, rg = t / 8;
      float as[2][4] = {}, ae[2][4] = {}, at[2][4] = {};
      for (int k = 0; k < D; ++k) {
        const float4 we = ld4(&W1E[k * HC + c4 * 4]);
        const float4 wt = ld4(&W1T[k * HC + c4 * 4]);
        const float2 x = *reinterpret_cast<const float2*>(&ST[k * LDS + rg * 2]);
        const float2 xn = *reinterpret_cast<const float2*>(&SNT[k * LDS + rg * 2]);
        const float xs[2] = {x.x, x.y}, xns[2] = {xn.x, xn.y};
        const float wes[4] = {we.x, we.y, we.z, we.w};
        const float wts[4] = {wt.x, wt.y, wt.z, wt.w};
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            as[m][i] = fmaf(xs[m], wes[i], as[m][i]);
            ae[m][i] = fmaf(xns[m], wes[i], ae[m][i]);
            at[m][i] = fmaf(xns[m], wts[i], at[m][i]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c4 * 4 + i;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int row = rg * 2 + m;
          H1T[(0 * HC + c) * LDS + row] = fmaxf(as[m][i] + B1E[c], 0.f);
          H1T[(1 * HC + c) * LDS + row] = fmaxf(ae[m][i] + B1E[c], 0.f);
          H1T[(2 * HC + c) * LDS + row] = fmaxf(at[m][i] + B1T[c], 0.f);
        }
      }
    }
    __syncthreads();

    // partial layer-2 sums over this rank's units: 4 rows x 4 j x 3 forwards
    {
      const int jg = t % 16, rg = t / 16;
      float acc[3][4][4] = {};
      for (int k = 0; k < HC; ++k) {
        const float4 we = ld4(&W2E[k * LDW2 + jg * 4]);
        const float4 wt = ld4(&W2T[k * LDW2 + jg * 4]);
        const float wes[4] = {we.x, we.y, we.z, we.w};
        const float wts[4] = {wt.x, wt.y, wt.z, wt.w};
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const float4 h = ld4(&H1T[(f * HC + k) * LDS + rg * 4]);
          const float hs[4] = {h.x, h.y, h.z, h.w};
          const float* w = f == 2 ? wts : wes;
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[f][m][i] = fmaf(hs[m], w[i], acc[f][m][i]);
        }
      }
#pragma unroll
      for (int f = 0; f < 3; ++f)
#pragma unroll
        for (int m = 0; m < 4; ++m)
          st4(&Z2P[(f * BT + rg * 4 + m) * H2 + jg * 4],
              make_float4(acc[f][m][0], acc[f][m][1], acc[f][m][2],
                          acc[f][m][3]));
    }
    cluster.sync();  // every rank's partials are written

    // the head of this rank's rows: warp w finishes row RPR rk + w
    {
      const int row = rk * RPR + warp, grow = r0 + row;
      float* hw = H2W + warp * 3 * H2;
      for (int j = lane; j < H2; j += 32) {
        float z[3] = {0.f, 0.f, 0.f};
        for (int q = 0; q < CL; ++q) {  // rank order
          const float* P = cluster.map_shared_rank(Z2P, q);
#pragma unroll
          for (int f = 0; f < 3; ++f) z[f] += P[(f * BT + row) * H2 + j];
        }
        hw[0 * H2 + j] = fmaxf(z[0] + B2E[j], 0.f);
        hw[1 * H2 + j] = fmaxf(z[1] + B2E[j], 0.f);
        hw[2 * H2 + j] = fmaxf(z[2] + B2T[j], 0.f);
      }
      __syncwarp();
      float* qw = QS + warp * 3 * A;
      for (int e = lane; e < 3 * A; e += 32) {
        const int f = e / A, c = e % A;
        const float* w3 = f == 2 ? W3T : W3E;
        float acc = 0.f;
        for (int j = 0; j < H2; ++j) acc = fmaf(hw[f * H2 + j], w3[j * A + c], acc);
        qw[e] = acc + (f == 2 ? B3T : B3E)[c];
      }
      __syncwarp();
      float gr = 0.f, hub = 0.f;
      int ar = -1;
      if (grow < B) {
        int best = 0;
        float bv = qw[A];
        for (int c = 1; c < A; ++c) {
          const float v = qw[A + c];
          if (v > bv) { bv = v; best = c; }  // first max wins ties
        }
        const float q_tn = qw[2 * A + best];
        ar = g.a[grow];
        // an action outside [0, A) selects nothing, as the Pallas kernel's
        // one-hot does
        const float q_sel = (ar >= 0 && ar < A) ? qw[ar] : 0.f;
        const float y = g.r[grow] + g.gamma * (1.f - g.done[grow]) * q_tn;
        const float err = y - q_sel;
        const float abse = fabsf(err);
        hub = abse <= 1.f ? 0.5f * err * err : abse - 0.5f;
        gr = -fminf(fmaxf(err, -1.f), 1.f) / static_cast<float>(B);
      }
      const bool sel = ar >= 0 && ar < A;
      for (int j = lane; j < H2; j += 32) {
        H2O[warp * H2 + j] = hw[j];
        // dh2 = (dq W3^T) * [z2 > 0]; dq has one nonzero per row
        DH2O[warp * H2 + j] = (sel && hw[j] > 0.f) ? gr * W3E[j * A + ar] : 0.f;
      }
      if (lane == 0) {
        ROWO[warp] = gr;
        ROWO[RPR + warp] = __int_as_float(sel ? ar : -1);
        ROWO[2 * RPR + warp] = hub;
      }
    }
    cluster.sync();  // every row's dh2 is written

    if (t == 0)
      for (int w = 0; w < RPR; ++w) lsum += ROWO[2 * RPR + w];
    // gather dh2, this rank's h2 columns, g and the action of every row
    for (int e = t; e < BT * (H2 / 4); e += THREADS) {
      const int row = e / (H2 / 4), j4 = e % (H2 / 4);
      const float* src = cluster.map_shared_rank(DH2O, row / RPR);
      st4(&DH2F[row * LDW2 + j4 * 4], ld4(&src[(row % RPR) * H2 + j4 * 4]));
    }
    for (int e = t; e < BT * JR; e += THREADS) {
      const int row = e / JR, jj = e % JR;
      const float* src = cluster.map_shared_rank(H2O, row / RPR);
      H2F[e] = src[(row % RPR) * H2 + rk * JR + jj];
    }
    for (int row = t; row < BT; row += THREADS) {
      const float* src = cluster.map_shared_rank(ROWO, row / RPR);
      GF[row] = src[row % RPR];
      AF[row] = __float_as_int(src[RPR + row % RPR]);
    }
    __syncthreads();

    // dh1 = (dh2 W2^T) * [z1 > 0] for this rank's units: 2 rows x 4 units
    {
      const int ci = t % 8, rg = t / 8;   // units ci + 8i
      float acc[2][4] = {};
      for (int j = 0; j < H2; j += 4) {
        const float4 d0 = ld4(&DH2F[(rg * 2) * LDW2 + j]);
        const float4 d1 = ld4(&DH2F[(rg * 2 + 1) * LDW2 + j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 w = ld4(&W2E[(ci + 8 * i) * LDW2 + j]);
          acc[0][i] = fmaf(d0.x, w.x, acc[0][i]);
          acc[0][i] = fmaf(d0.y, w.y, acc[0][i]);
          acc[0][i] = fmaf(d0.z, w.z, acc[0][i]);
          acc[0][i] = fmaf(d0.w, w.w, acc[0][i]);
          acc[1][i] = fmaf(d1.x, w.x, acc[1][i]);
          acc[1][i] = fmaf(d1.y, w.y, acc[1][i]);
          acc[1][i] = fmaf(d1.z, w.z, acc[1][i]);
          acc[1][i] = fmaf(d1.w, w.w, acc[1][i]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ci + 8 * i, row = rg * 2 + m;
          DH1[row * LDD + c] = H1T[c * LDS + row] > 0.f ? acc[m][i] : 0.f;
        }
    }
    __syncthreads();

    // gradient sums over the pass's rows, each element owned by one thread
    for (int k = t / 8; k < D; k += THREADS / 8) {  // dW1 = s^T dh1
      const int c4 = t % 8;
      float4 acc = ld4(&GW1[k * HC + c4 * 4]);
      for (int row = 0; row < BT; row += 4) {
        const float4 x = ld4(&ST[k * LDS + row]);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float4 d = ld4(&DH1[(row + m) * LDD + c4 * 4]);
          acc.x = fmaf(xs[m], d.x, acc.x);
          acc.y = fmaf(xs[m], d.y, acc.y);
          acc.z = fmaf(xs[m], d.z, acc.z);
          acc.w = fmaf(xs[m], d.w, acc.w);
        }
      }
      st4(&GW1[k * HC + c4 * 4], acc);
    }
    if (t < HC) {  // db1
      float acc = GB1[t];
      for (int row = 0; row < BT; ++row) acc += DH1[row * LDD + t];
      GB1[t] = acc;
    }
    {  // dW2 = h1^T dh2 for this rank's rows of W2: 2 rows x 4 j
      const int jg = t % 16, c0 = (t / 16) * 2;
      float4 a0 = ld4(&GW2[c0 * H2 + jg * 4]);
      float4 a1 = ld4(&GW2[(c0 + 1) * H2 + jg * 4]);
      for (int row = 0; row < BT; row += 4) {
        const float4 h0 = ld4(&H1T[c0 * LDS + row]);
        const float4 h1 = ld4(&H1T[(c0 + 1) * LDS + row]);
        const float h0s[4] = {h0.x, h0.y, h0.z, h0.w};
        const float h1s[4] = {h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float4 d = ld4(&DH2F[(row + m) * LDW2 + jg * 4]);
          a0.x = fmaf(h0s[m], d.x, a0.x); a0.y = fmaf(h0s[m], d.y, a0.y);
          a0.z = fmaf(h0s[m], d.z, a0.z); a0.w = fmaf(h0s[m], d.w, a0.w);
          a1.x = fmaf(h1s[m], d.x, a1.x); a1.y = fmaf(h1s[m], d.y, a1.y);
          a1.z = fmaf(h1s[m], d.z, a1.z); a1.w = fmaf(h1s[m], d.w, a1.w);
        }
      }
      st4(&GW2[c0 * H2 + jg * 4], a0);
      st4(&GW2[(c0 + 1) * H2 + jg * 4], a1);
    }
    for (int e = t; e < JR * A; e += THREADS) {  // dW3 = h2^T dq, own rows
      const int jj = e / A, c = e % A;
      float acc = GW3[e];
      for (int row = 0; row < BT; ++row)
        if (AF[row] == c) acc = fmaf(H2F[row * JR + jj], GF[row], acc);
      GW3[e] = acc;
    }
    if (t < JR) {  // db2, own entries
      float acc = GB2[t];
      for (int row = 0; row < BT; ++row) acc += DH2F[row * LDW2 + rk * JR + t];
      GB2[t] = acc;
    }
    if (rk == 0 && t < A) {  // db3
      float acc = GB3[t];
      for (int row = 0; row < BT; ++row)
        if (AF[row] == t) acc += GF[row];
      GB3[t] = acc;
    }
    __syncthreads();
  }

  // global-norm clip: this rank's sum of squares, then the cluster's
  float sq = 0.f;
  for (int e = t; e < D * HC; e += THREADS) sq = fmaf(GW1[e], GW1[e], sq);
  for (int e = t; e < HC * H2; e += THREADS) sq = fmaf(GW2[e], GW2[e], sq);
  for (int e = t; e < JR * A; e += THREADS) sq = fmaf(GW3[e], GW3[e], sq);
  if (t < HC) sq = fmaf(GB1[t], GB1[t], sq);
  if (t < JR) sq = fmaf(GB2[t], GB2[t], sq);
  if (rk == 0 && t < A) sq = fmaf(GB3[t], GB3[t], sq);
  sq = block_sum(sq, RED);
  if (t == 0) {
    RED[WARPS + 1] = sq;
    RED[WARPS + 2] = lsum;
  }
  cluster.sync();
  float tsq = 0.f, tloss = 0.f;
  for (int q = 0; q < CL; ++q) {  // rank order
    const float* x = cluster.map_shared_rank(RED, q);
    tsq += x[WARPS + 1];
    tloss += x[WARPS + 2];
  }
  const float gnorm = sqrtf(tsq);
  const float clip = fminf(1.f, GRAD_CLIP / fmaxf(gnorm, 1e-9f));
  if (rk == 0 && t == 0) g.loss[0] = tloss / static_cast<float>(B);

  float c1 = 0.f, c2 = 0.f;
  if (FOLD_ADAM) {
    const float stepf = static_cast<float>(g.step[0] + 1);
    c1 = 1.f - powf(ADAM_B1, stepf);
    c2 = 1.f - powf(ADAM_B2, stepf);
  }
  // emit, or apply Adam to, the slices this rank owns: element e of slice
  // s (gradient sum acc[e]) is entry at(e) of parameter s.  A thread's
  // elements go in batches of EB, their loads issued before any store (the
  // compiler cannot tell that the outputs alias no input, so it keeps them
  // in order).
  constexpr int EB = 8;
  auto emit = [&](int s, int n, const float* acc, auto at) {
    for (int e0 = t; e0 < n; e0 += EB * THREADS) {
      float m[EB], v[EB], p[EB];
#pragma unroll
      for (int k = 0; k < EB; ++k) {
        const int e = e0 + k * THREADS;
        if (FOLD_ADAM && e < n) {
          const int i = at(e);
          m[k] = g.mu.p[s][i];
          v[k] = g.nu.p[s][i];
          p[k] = g.eval.p[s][i];
        }
      }
#pragma unroll
      for (int k = 0; k < EB; ++k) {
        const int e = e0 + k * THREADS;
        if (e >= n) break;
        const int i = at(e);
        const float gg = acc[e] * clip;
        if (!FOLD_ADAM) {
          g.out[s][i] = gg;
        } else {
          const float mk = ADAM_B1 * m[k] + ONE_MINUS_B1 * gg;
          const float vk = ADAM_B2 * v[k] + ONE_MINUS_B2 * gg * gg;
          g.out_m[s][i] = mk;
          g.out_v[s][i] = vk;
          g.out[s][i] = p[k] - g.lr * (mk / c1) / (sqrtf(vk / c2) + ADAM_EPS);
        }
      }
    }
  };
  emit(0, D * HC, GW1, [&](int e) { return (e / HC) * H1 + rk * HC + e % HC; });
  emit(1, HC, GB1, [&](int e) { return rk * HC + e; });
  emit(2, HC * H2, GW2, [&](int e) { return rk * HC * H2 + e; });
  emit(3, JR, GB2, [&](int e) { return rk * JR + e; });
  emit(4, JR * A, GW3, [&](int e) { return rk * JR * A + e; });
  emit(5, rk == 0 ? A : 0, GB3, [&](int e) { return e; });
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The dynamic shared memory each variant may use, set once per device and
// raised only when a wider shape needs more.
constexpr int MAX_DEVICES = 64;
int smem_set[2][MAX_DEVICES];

using KernelFn = void (*)(Args);

KernelFn kernel_for(int fold_adam) {
  return fold_adam ? dqn_td_kernel<true> : dqn_td_kernel<false>;
}

cudaError_t ensure_smem(int fold_adam, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int& set = smem_set[fold_adam ? 1 : 0][dev];
  if (set < smem) {
    err = cudaFuncSetAttribute(kernel_for(fold_adam),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    set = smem;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the cluster needs at widths (D, A).
int dqn_td_smem_bytes(int D, int A) {
  return layout(D, A).total * static_cast<int>(sizeof(float));
}

// The launch plan at batch B: cluster size (the grid of one lane), threads
// a block, batch rows a pass, passes.  Writes 4 ints to out.
void dqn_td_plan(int B, int* out) {
  out[0] = CL;
  out[1] = THREADS;
  out[2] = BT;
  out[3] = (B + BT - 1) / BT;
}

// How many clusters (lanes) of the variant the current device holds at
// once at widths (D, A): writes it to *out and returns the CUDA error code.
int dqn_td_max_active_clusters(int D, int A, int fold_adam, int* out) {
  const int smem = dqn_td_smem_bytes(D, A);
  cudaError_t err = ensure_smem(fold_adam, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel_for(fold_adam), &cfg);
}

const char* dqn_td_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ptrs holds, in order: s, a, r, s', done, eval[6], targ[6], mu[6], nu[6],
// step, loss, out[6], out_m[6], out_v[6]  (49 device pointers; mu, nu,
// step, out_m and out_v are null for the grads variant).  The batch, mu,
// nu, step, loss and outputs carry a leading axis of L lanes; eval / targ
// carry it when lane_eval / lane_targ is set and are shared otherwise.
// Launches L clusters of CL blocks on `stream` and returns the launch's
// CUDA error code (0 on success).
int dqn_td_launch(void* const* ptrs, int L, int B, int D, int A, float gamma,
                  float lr, int fold_adam, int lane_eval, int lane_targ,
                  void* stream) {
  if (L < 1 || B < 1 || D < 1 || A < 1) return (int)cudaErrorInvalidValue;
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
  g.lane_eval = lane_eval;
  g.lane_targ = lane_targ;
  // a parameter copies 16 bytes at a time only where every lane's slice
  // starts on a 16-byte boundary
  const size_t sz[6] = {static_cast<size_t>(D) * H1, H1,
                        static_cast<size_t>(H1) * H2, H2,
                        static_cast<size_t>(H2) * A, static_cast<size_t>(A)};
  g.vec = 0;
  for (int net = 0; net < 2; ++net) {
    const Net& n = net == 0 ? g.eval : g.targ;
    const bool laned = L > 1 && (net == 0 ? lane_eval : lane_targ);
    for (int i = 0; i < 6; ++i)
      if (reinterpret_cast<size_t>(n.p[i]) % 16 == 0 &&
          (!laned || (sz[i] * sizeof(float)) % 16 == 0))
        g.vec |= 1u << (net * 6 + i);
  }

  const int smem = dqn_td_smem_bytes(D, A);
  cudaError_t err = ensure_smem(fold_adam, smem);
  if (err != cudaSuccess) return (int)err;
  kernel_for(fold_adam)<<<CL * L, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
