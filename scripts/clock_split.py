"""Where the kernels spend their time: each phase's clock64 cycles in block 0.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/clock_split.py <label> [checkout] [mlp|tower|walk]

It copies the csrc/ of `checkout` (by default the one it runs from; give a
second checkout, e.g. a git archive of a parent commit, to split that
one's kernels) into a temporary directory and inserts a probe after each
phase of the kernels it splits: thread 0 of block 0 adds the clock64
cycles since its last probe to that phase's counter. `mlp` (the default)
splits update.cu's K3, both arms, each run once on hover.toml's full-width
minibatch, acting.cu's K5 at 65,536 lanes x 1,001 steps, and
acting_traj.cu's K2, both arms, at 65,536 lanes x 64 steps (its rollout on
hover.toml; per step: the observation with its plane stores, each tower,
the heads' read-back, the noise, the log-prob, the action, log-prob and
value stores, the env step, the reward and done stores with the
statistics) (hover, [64, 64]); `tower` splits the bf16 arms' patch-CNN tower tiles
(cnn_mma.cuh tower_fwd_tile<true> and tower_bwd_tile<true>: the render,
conv0 (and its re-run), conv1, the trunk, the X2 copy, dX2, gW1, dX1, gW0
and the barriers) inside K10's bf16 update (update_cnn.cu: cnn_fwd_kernel,
tower_bwd_kernel) and K7's CNN arm's (update_lstm.cu: tower_fwd_kernel,
tower_bwd_kernel), each on one full-width minibatch of its path, with each
kernel's whole time in block 0 beside its tile's phases; `walk` splits
K7's bf16 walk through time (update_lstm.cu bptt_kernel<ENC, true>), the
dense arm and the CNN arm each on one full-width minibatch of its path
(65,536 envs x 128 steps, bptt 16, a quarter of the lanes): the forward's
x in, h_in to the XS scratch, the dense encoder, the gate block's products,
the cell with its GF and H2S writes, h' and the heads with the carry mask;
the backward's heads' gradients, the GF reads with the cell's backward,
[dx; dh] (gates_bwd_mma), the GZ copy and the encoder's backward (dense)
or dzt (CNN); each barrier apart. It builds the
copies with that checkout's nvcc flags, runs each once after one warm-up
launch through that checkout's wrappers, and prints each phase's cycles
and share of its kernel's total, one JSON line. The probes are anchored
on lines of the sources, per kernel design the script knows: a source in
which no design's anchors are each found once fails. The probed copies
run slower than the kernels; the shares are what the split is for.
"""
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

label = sys.argv[1]
checkout = Path(sys.argv[2] if len(sys.argv) > 2 else ".").resolve()
which = sys.argv[3] if len(sys.argv) > 3 else "mlp"
if which not in ("mlp", "tower", "walk"):
    raise SystemExit(f"the third argument is mlp, tower or walk, got "
                     f"{which}")
sys.path.insert(0, str(checkout))
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from drone_tpu_torch.ops import cuda_build  # noqa: E402

PROBES = r"""
#include <cuda_runtime.h>
__device__ unsigned long long drone_clk[32];
#define CLK_START long long drone_t0 = clock64();
#define CLK(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
  const long long drone_t1 = clock64(); \
  drone_clk[k] += (unsigned long long)(drone_t1 - drone_t0); \
  drone_t0 = drone_t1; } } while (0)
extern "C" int drone_clk_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, drone_clk, sizeof(drone_clk));
}
extern "C" int drone_clk_zero() {
  const unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(drone_clk, z, sizeof(z));
}
"""

# per source: the phase names, then (anchor, probe put after it) for each
# tree the script knows (the fp32 kernels, the tensor-core ones); the first
# tree whose every anchor is present once is taken. The tensor-core K3's
# probes name its layers (at two hidden layers: 0, 1 and the head).
SPLITS = {
    "update": [
        # the fp32 arm's phases (as the second tree's) and, after them, the
        # bf16 arm's own design (update_kernel<ONCHIP, true> on a BLayout)
        ({0: "load", 1: "fwd 0", 2: "fwd 1", 3: "fwd head", 4: "head grads",
          5: "stat sums", 6: "dW 0", 7: "dW 1", 8: "dW head", 9: "dX 1",
          10: "dX head", 11: "load", 12: "fwd 0", 13: "fwd 1", 14: "fwd head",
          15: "head grads", 16: "stat and db sums", 17: "dW 0", 18: "dW 1",
          19: "dW head", 20: "dX 1", 21: "dX head"}, [
            ("  float st_acc = 0.0f;\n  __syncthreads();\n",
             "  CLK_START\n"),
            (": 0.0f;\n    __syncthreads();\n", "    CLK(0);\n"),
            ("      layer_fwd(act, lo, l, A.theta, wb, ws);\n"
             "      __syncthreads();\n", "      CLK(1 + l);\n"),
            ("stat_part[w][4 + lane] = sv[4];\n    }\n    __syncthreads();\n",
             "    CLK(4);\n"),
            ("      st_acc = st_acc + tile_sum;\n    }\n", "    CLK(5);\n"),
            ("      layer_dw(act, lo, l, sums);\n      __syncthreads();\n",
             "      CLK(6 + l);\n"),
            ("      layer_dx(act, lo, l, wb, ws);\n      __syncthreads();\n",
             "      CLK(8 + l);\n"),
            ("  __syncthreads();  // the layout, the zeroed rows and sums\n",
             "  CLK_START\n"),
            ("    __syncthreads();  // the tile's obs rows\n", "    CLK(11);\n"),
            ("      fwd_b16(lo, l, xb, yh, hf, wf, A.theta);\n"
             "      __syncthreads();\n", "      CLK(12 + l);\n"),
            ("<@>    if (tid < B16_HEAD_STATS) {\n", ("    CLK(15);\n",)),
            ("<@>    for (int l = lo.L; l >= 0; --l) {\n      dw_b16(",
             ("    CLK(16);\n",)),
            ("      dw_b16(lo, l, xb, sums);\n      __syncthreads();\n",
             "      CLK(17 + l);\n"),
            ("      dx_b16(lo, l, xb, yh, wf, sums);\n      __syncthreads();\n",
             "      CLK(19 + l);\n")]),
        (("load", "actor fwd", "critic fwd", "head grads", "stat sums",
          "actor bwd", "critic bwd"), [
            ("  float st_acc = 0.0f;\n  bool first = true;\n",
             "  CLK_START\n"),
            ("      sm[row * SP + s] = v;\n    }\n    __syncthreads();\n",
             "    CLK(0);\n"),
            ("    tower_fwd(sm, ta, RA, HM, A.theta);\n", "    CLK(1);\n"),
            ("    tower_fwd(sm, tc, RC, HV, A.theta);\n", "    CLK(2);\n"),
            ("sm[(IN + k) * SP + s] = st[k];\n    }\n    __syncthreads();\n",
             "    CLK(3);\n"),
            ("      st_acc = st_acc + tile_sum;\n    }\n", "    CLK(4);\n"),
            ("    tower_bwd(sm, ta, RA, HM, A.theta, part, first);\n"
             "    __syncthreads();\n", "    CLK(5);\n"),
            ("    tower_bwd(sm, tc, RC, HV, A.theta, part, first);\n"
             "    __syncthreads();\n", "    CLK(6);\n")]),
        (("load", "fwd 0", "fwd 1", "fwd head", "head grads", "stat sums",
          "dW 0", "dW 1", "dW head", "dX 1", "dX head"), [
            ("  float st_acc = 0.0f;\n  __syncthreads();\n",
             "  CLK_START\n"),
            (": 0.0f;\n    __syncthreads();\n", "    CLK(0);\n"),
            ("      layer_fwd(act, lo, l, A.theta, wb, ws);\n"
             "      __syncthreads();\n", "      CLK(1 + l);\n"),
            ("stat_part[w][4 + lane] = sv[4];\n    }\n    __syncthreads();\n",
             "    CLK(4);\n"),
            ("      st_acc = st_acc + tile_sum;\n    }\n", "    CLK(5);\n"),
            ("      layer_dw(act, lo, l, sums);\n      __syncthreads();\n",
             "      CLK(6 + l);\n"),
            ("      layer_dx(act, lo, l, wb, ws);\n      __syncthreads();\n",
             "      CLK(8 + l);\n")]),
        # the same phases, the kernel templated on its bf16 arm
        (("load", "fwd 0", "fwd 1", "fwd head", "head grads", "stat sums",
          "dW 0", "dW 1", "dW head", "dX 1", "dX head"), [
            ("  float st_acc = 0.0f;\n  __syncthreads();\n",
             "  CLK_START\n"),
            (": 0.0f;\n    __syncthreads();\n", "    CLK(0);\n"),
            ("      layer_fwd<BF16>(act, lo, l, A.theta, wb, ws);\n"
             "      __syncthreads();\n", "      CLK(1 + l);\n"),
            ("stat_part[w][4 + lane] = sv[4];\n    }\n    __syncthreads();\n",
             "    CLK(4);\n"),
            ("      st_acc = st_acc + tile_sum;\n    }\n", "    CLK(5);\n"),
            ("      layer_dw<BF16>(act, lo, l, sums);\n      __syncthreads();\n",
             "      CLK(6 + l);\n"),
            ("      layer_dx<BF16>(act, lo, l, wb, ws);\n      __syncthreads();\n",
             "      CLK(8 + l);\n")]),
    ],
    "acting_traj": [
        # both arms' towers apart (the bf16 arm's since its redesign)
        (("observe", "actor", "critic", "heads out", "noise", "log-prob",
          "plane stores", "env step", "stats"), [
            ("  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};\n",
             "  CLK_START\n"),
            ("      if (live) out[(size_t)k * n] = o[k];\n    }\n"
             "    __syncwarp();\n", "    CLK(0);\n"),
            ("      traj_tower_b16(lo, Wb, ba, actb, hacc);\n",
             "      CLK(1);\n"),
            ("      traj_tower_b16(lo, Wb + 2 * lo.f4, ba + lo.nb, actb, hacc);"
             "\n", "      CLK(2);\n"),
            ("      traj_tower(lo, W, ba, act, hacc);\n", "      CLK(1);\n"),
            ("      traj_tower(lo, W + lo.f4, ba + lo.nb, act, hacc);\n",
             "      CLK(2);\n"),
            ("                         : act[TRAJ_VALUE_COL * lo.as + lane];\n",
             "    CLK(3);\n"),
            ("    if (STOCH) gauss4(c.k0, c.k1, c.rc, c.stp, z);\n",
             "    CLK(4);\n"),
            ("    sample_logp(m, z, sm, sm + 4, STOCH, a, logp);\n",
             "    CLK(5);\n"),
            ("    out[(size_t)TP_VAL * n] = v;\n", "    CLK(6);\n"),
            ("                          step2);\n", "    CLK(7);\n"),
            ("    accumulate(acc, r, done, epret2, step2);\n",
             "    CLK(8);\n")]),
        (("observe", "actor", "critic", "heads out", "noise", "log-prob",
          "plane stores", "env step", "stats"), [
            ("  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};\n",
             "  CLK_START\n"),
            ("      if (live) out[(size_t)k * n] = o[k];\n    }\n"
             "    __syncwarp();\n", "    CLK(0);\n"),
            ("    traj_tower<BF16>(lo, W, ba, act, hacc);\n", "    CLK(1);\n"),
            ("    traj_tower<BF16>(lo, W + lo.f4, ba + lo.nb, act, hacc);\n",
             "    CLK(2);\n"),
            ("    const float v = act[TRAJ_VALUE_COL * lo.as + lane];\n",
             "    CLK(3);\n"),
            ("    if (STOCH) gauss4(c.k0, c.k1, c.rc, c.stp, z);\n",
             "    CLK(4);\n"),
            ("    sample_logp(m, z, sm, sm + 4, STOCH, a, logp);\n",
             "    CLK(5);\n"),
            ("    out[(size_t)TP_VAL * n] = v;\n", "    CLK(6);\n"),
            ("                          step2);\n", "    CLK(7);\n"),
            ("    accumulate(acc, r, done, epret2, step2);\n",
             "    CLK(8);\n")]),
    ],
    "acting": [
        (("observe", "tower", "noise", "env step", "statistics"), [
            ("  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};\n",
             "  CLK_START\n"),
            ("    for (int k = 0; k < OBS_DIM; ++k) col_obs[k * B] = o[k];\n",
             "    CLK(0);\n"),
            ("    tower<4>(sw, tw, col_obs, col_a, col_b, B, a);\n",
             "    CLK(1);\n"),
            ("a[k] = a[k] + tw.std[k] * z[k];\n    }\n", "    CLK(2);\n"),
            ("                          step2);\n", "    CLK(3);\n"),
            ("    accumulate(acc, r, done, epret2, step2);\n",
             "    CLK(4);\n")]),
        (("observe", "tower", "noise", "env step", "statistics"), [
            ("  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};\n",
             "  CLK_START\n"),
            ("live ? o[k] : 0.0f;\n    __syncwarp();\n", "    CLK(0);\n"),
            ("    warp_tower(lo, W, act, a);\n", "    CLK(1);\n"),
            ("a[k] = a[k] + lo.std[k] * z[k];\n    }\n", "    CLK(2);\n"),
            ("                          step2);\n", "    CLK(3);\n"),
            ("    accumulate(acc, r, done, epret2, step2);\n",
             "    CLK(4);\n")]),
    ],
}


# The bf16 tower tiles (cnn_mma.cuh) and the kernels around them. A
# design's anchors may hold "<@>" marks: each takes the next of its probe
# texts. Counters 0-5 split tower_fwd_tile, 7 is its kernel's whole time in
# block 0 (K10's cnn_fwd_kernel, K7's tower_fwd_kernel); 8-14 split
# tower_bwd_tile, 15 is tower_bwd_kernel's whole time.
TOWER_NAMES = {0: "fwd render", 1: "fwd conv0", 2: "fwd conv1",
               3: "fwd trunk", 4: "fwd X2 out", 5: "fwd barriers",
               7: "fwd kernel", 8: "bwd render", 9: "bwd conv0", 10: "dX2",
               11: "gW1", 12: "dX1", 13: "gW0", 14: "bwd barriers",
               15: "bwd kernel"}
TOWER_TILES = [
    # the parent's design: fp32 rows, one TF32 product a k-step
    (TOWER_NAMES, [
        ("  zero_frags(tacc);\n<@>  render_patch<TM_L, TM_S>(window_patch(0, "
         "0), sp, grid, xr);\n<@>  __syncthreads();\n<@>",
         ("  CLK_START\n", "  CLK(0);\n", "  CLK(5);\n")),
        ("xn);\n<@>    conv_mma<1, true, BF16>(xb, CNN_K0, w0, theta + "
         "OFF_B0, yb);\n<@>    __syncthreads();\n<@>",
         ("    CLK(0);\n", "    CLK(1);\n", "    CLK(5);\n")),
        ("k * (CNN_C0 / 8), ntc, c1);\n<@>", ("    CLK(2);\n",)),
        ("      zero_frags(c1);\n<@>      __syncthreads();\n<@>",
         ("      CLK(2);\n", "      CLK(5);\n")),
        ("nt0, tacc);\n<@>      on_window(q1, y1);\n<@>      __syncthreads();"
         "  // patch j + 2 renders over y1\n<@>",
         ("      CLK(3);\n", "      CLK(4);\n", "      CLK(5);\n")),
        ("  store_relu(tacc, m0, nt0, theta + OFF_BT, y0);\n<@>",
         ("  CLK(3);\n",)),
        ("wq = w >> 1;\n<@>  for (int q1 = 0; q1 < CNN_NQ1; ++q1) {\n"
         "    for (int k = 0; k < CNN_WIN; ++k)\n      render_patch",
         ("  CLK_START\n",)),
        ("                               xr + k * CNN_K0 * TM_S);\n<@>"
         "    __syncthreads();\n<@>", ("    CLK(8);\n", "    CLK(14);\n")),
        ("y0 + k * CNN_C0 * TM_S);\n<@>", ("    CLK(9);\n",)),
        ("(xa[NL + m + 8] > 0.0f ? 1.0f : 0.0f);\n        }\n      }\n    }\n"
         "<@>    __syncthreads();\n<@>", ("    CLK(10);\n", "    CLK(14);\n")),
        ("      if (lane == r) gr.b1 = gr.b1 + v;\n    }\n<@>"
         "    __syncthreads();\n<@>", ("    CLK(11);\n", "    CLK(14);\n")),
        ("(y[TM_S + 8] > 0.0f ? 1.0f : 0.0f);\n        }\n      }\n    }\n"
         "<@>    __syncthreads();\n<@>", ("    CLK(12);\n", "    CLK(14);\n")),
        ("      if (lane == r) gr.b0 = gr.b0 + v;\n    }\n<@>    "
         "__syncthreads();  // the next window renders over xr and y0\n<@>",
         ("    CLK(13);\n", "    CLK(14);\n")),
        ("  gr.b0 = 0.0f;\n<@>", ("  CLK_START\n",)),
        ("  tower_grads_out(gr, sm, A.partial + (size_t)(A.row0 + blockIdx.x)"
         " * A.ptot);\n<@>", ("  CLK(15);\n",))]),
    # the bf16 design: bf16 rows, m16n8k16 products (tower_fwd_b16,
    # tower_bwd_b16); gW1's and gW0's phases hold gb1's and gb0's adds
    (TOWER_NAMES, [
        ("<@>  render_patch_b16(window_patch(0, 0), sp, grid, xr);\n<@>"
         "  __syncthreads();\n<@>",
         ("  CLK_START\n", "  CLK(0);\n", "  CLK(5);\n")),
        ("grid, xr + ((j + 1) & 1) * CNN_K0 * TMB);\n<@>", ("    CLK(0);\n",)),
        ("      store_relu_b16(acc, mc, ntc, theta + OFF_B0, yb);\n    }\n<@>"
         "    __syncthreads();\n<@>", ("    CLK(1);\n", "    CLK(5);\n")),
        ("k * (CNN_C0 / 16),\n                          ntc, c1);\n<@>",
         ("    CLK(2);\n",)),
        ("      store_relu_both(c1, mc, ntc, theta + OFF_B1, y1, y1b);\n"
         "      zero_frags(c1);\n<@>      __syncthreads();\n<@>",
         ("      CLK(2);\n", "      CLK(5);\n")),
        ("q1 * (CNN_C1 / 16), nt0, tacc);\n<@>      on_window(q1, "
         "static_cast<const float*>(y1));\n<@>",
         ("      CLK(3);\n", "      CLK(4);\n")),
        ("  __syncthreads();  // h goes over y0 and y1\n<@>  store_relu(tacc, "
         "m0, nt0, theta + OFF_BT, rows + TFB_H);\n<@>",
         ("  CLK(5);\n", "  CLK(3);\n")),
        ("  const int mc = 16 * CMI * (w % CMW), ntc = CNI * (w / CMW);\n<@>"
         "  for (int q1 = 0; q1 < CNN_NQ1; ++q1) {\n"
         "    for (int k = 0; k < CNN_WIN; ++k)\n      render_patch_b16",
         ("  CLK_START\n",)),
        ("render_patch_b16(window_patch(q1, k), sp, grid, xr + k * CNN_K0 * "
         "TMB);\n<@>    __syncthreads();\n<@>",
         ("    CLK(8);\n", "    CLK(14);\n")),
        ("      store_relu_b16(acc, mc, ntc, theta + OFF_B0, y0 + k * CNN_C0 * "
         "TMB);\n    }\n<@>", ("    CLK(9);\n",)),
        ("          rs1[(w % CMW) * CNN_C1 + n + 1] = s1;\n        }\n      }\n"
         "    }\n<@>    __syncthreads();\n<@>",
         ("    CLK(10);\n", "    CLK(14);\n")),
        ("      fold(gr.w1, qq, acc);\n    }\n<@>    __syncthreads();\n<@>",
         ("    CLK(11);\n", "    CLK(14);\n")),
        ("          rs0[(w & 1) * CNN_K1 + n + 1] = s1;\n        }\n      }\n"
         "    }\n<@>    __syncthreads();\n<@>",
         ("    CLK(12);\n", "    CLK(14);\n")),
        ("      fold(gr.w0, 0, acc);\n    }\n<@>    __syncthreads();  // the "
         "next window renders over xr and y0\n<@>",
         ("    CLK(13);\n", "    CLK(14);\n")),
        ("  gr.b0 = 0.0f;\n<@>", ("  CLK_START\n",)),
        ("  tower_grads_out(gr, sm, A.partial + (size_t)(A.row0 + blockIdx.x)"
         " * A.ptot);\n<@>", ("  CLK(15);\n",))]),
]
TOWER_KERNELS = {
    name: [({}, [(f"  tower_load_w0{arm}(sm, A.pk);  // before the first "
                  f"tile's barriers\n<@>", ("  CLK_START\n",)), end])
           for arm in ("", "<BF16>")]
    for name, end in (
        ("update_cnn", ("    part[N_HEADS + tid] = s;\n  }\n<@>",
                        ("  CLK(7);\n",))),
        ("update_lstm", ("      xs[(size_t)(OBS_DIM + k) * NL + l] = "
                         "hh[k * S + l];\n    }\n  }\n<@>",
                         ("  CLK(7);\n",))))
}

# K7's bf16 walk through time (update_lstm.cu), its phases per step in
# block 0's thread 0, summed over the minibatch's segments; the probes in
# the cell's callback split the gate block: its products run up to the
# callback's first call in each pass.
WALK_NAMES = {16: "anchors in", 0: "fwd x in", 1: "fwd h_in to XS",
              2: "fwd encoder", 3: "fwd gate products",
              4: "fwd cell, GF and H2S writes", 5: "fwd h' and barrier",
              6: "fwd heads and mask", 7: "fwd barrier",
              8: "bwd heads' gradients", 9: "bwd barrier 1",
              10: "bwd GF reads and cell", 11: "bwd barrier 2",
              12: "bwd [dx; dh] product", 13: "bwd GZ copy",
              14: "bwd encoder or dzt", 15: "stat sums"}
WALK = [
    # the parent's design: fp32 rows, the operands rounded as they load
    (WALK_NAMES, [
        ("  float ls[4], stdv[4];\n<@>", ("  CLK_START\n",)),
        ("    x[(E + e / L) * S + e % L] = 0.0f;  // x's padded rows\n"
         "  __syncthreads();\n<@>", ("  CLK(16);\n",)),
        ("        xs[(size_t)k * NL + l] = v;\n      }\n    }\n<@>",
         ("    CLK(0);\n",)),
        ("      xs[(size_t)(h_row + u) * NL + l] = h[u * S + l];\n    }\n"
         "    __syncthreads();\n<@>", ("    CLK(1);\n",)),
        ("<@>    float* gfs = A.s[GF] + (size_t)t * 6 * Hp * NL + (size_t)ml0 "
         "* 6 * Hp;\n", ("    CLK(2);\n",)),
        ("float gg, float go) {\n<@>                     const float cin = "
         "cr[p][i][r];\n", ("                     CLK(3);\n",)),
        ("                     if (u < H) h2s[(size_t)u * NL + l] = h2;\n<@>"
         "                     return h2;\n",
         ("                     CLK(4);\n",)),
        ("                   });\n    __syncthreads();\n<@>    // the heads "
         "at h'", ("    CLK(5);\n",)),
        ("          cr[p][i][r] = cr[p][i][r] * (1.0f - done[owned_lane(i, "
         "r)]);\n<@>    __syncthreads();\n<@>  }\n",
         ("    CLK(6);\n", "    CLK(7);\n")),
        ("      keep_s[tid] = 1.0f - pt[(size_t)TP_DONE * n + tid];\n    }\n"
         "<@>    __syncthreads();\n<@>", ("    CLK(8);\n", "    CLK(9);\n")),
        ("            dz[(32 * ug + 8 * g + u % 8) * S + l] = z[g];\n"
         "        }\n      }\n    }\n<@>    __syncthreads();\n<@>",
         ("    CLK(10);\n", "    CLK(11);\n")),
        ("    gates_bwd_mma<BF16>(dz, E, H, A.PGT, want_dx, dx, dh);\n<@>",
         ("    CLK(12);\n",)),
        ("              dz + (32 * (u / 8) + 8 * g + u % 8) * S + l4);\n"
         "    }\n    __syncthreads();\n<@>", ("    CLK(13);\n",)),
        ("(xv > 0.0f ? 1.0f : 0.0f);\n      }\n<@>      continue;\n",
         ("      CLK(14);\n",)),
        ("        d = d2;\n      }\n    }\n<@>  }\n", ("    CLK(14);\n",)),
        ("    A.stat_part[(size_t)blockIdx.x * N_UPSTATS + tid] = s;\n  }\n"
         "<@>}\n", ("  CLK(15);\n",))]),
    # the bf16 tensor cores' design (bptt_walk_b16): dz to GZ from the
    # cell's registers, so counter 13 is the barrier after [dx; dh] alone
    ({**WALK_NAMES, 13: "bwd barrier 3"}, [
        ("  const uint2* PGT = reinterpret_cast<const uint2*>(A.PGT);\n<@>",
         ("  CLK_START\n",)),
        ("    hb[(Hp + e / L) * TMB + e % L] = 0;  // K's, to a multiple of 16\n"
         "  cp_async_wait<0>();  // the CNN arm's first x\n"
         "  __syncthreads();\n<@>", ("  CLK(16);\n",)),
        ("          xb[k * TMB + l] = bf16_bits(v);\n      }\n    }\n<@>",
         ("    CLK(0);\n",)),
        ("      xs[(size_t)(h_row + u) * NL + l] = b16_value(hb[u * TMB + l]);"
         "\n    }\n    __syncthreads();\n<@>", ("    CLK(1);\n",)),
        ("<@>    float* gfs = A.s[GF] + (size_t)t * GF_B16 * Hp * NL +\n",
         ("    CLK(2);\n",)),
        ("float gg, float go) {\n<@>                     const float cin = "
         "cr[p][i][r];\n", ("                     CLK(3);\n",)),
        ("                     if (u < H) h2s[(size_t)u * NL + l] = h2;\n<@>"
         "                     return h2;\n",
         ("                     CLK(4);\n",)),
        ("                   });\n    __syncthreads();\n<@>    // the heads "
         "at h' (to the DMV scratch)", ("    CLK(5);\n",)),
        ("          cr[p][i][r] = cr[p][i][r] * (1.0f - done[owned_lane(i, "
         "r)]);\n<@>    cp_async_wait<0>();  // the CNN arm's next x\n"
         "    __syncthreads();\n<@>  }\n", ("    CLK(6);\n", "    CLK(7);\n")),
        ("      keep_s[tid] = 1.0f - pt[(size_t)TP_DONE * n + tid];\n    }\n"
         "<@>    __syncthreads();\n<@>", ("    CLK(8);\n", "    CLK(9);\n")),
        ("            dzb[(32 * ug + 8 * g + u % 8) * TMB + l] = bf16_bits(z[r]"
         "[g]);\n        }\n      }\n    }\n<@>    __syncthreads();\n<@>",
         ("    CLK(10);\n", "    CLK(11);\n")),
        ("                  dh);\n<@>    __syncthreads();\n<@>",
         ("    CLK(12);\n", "    CLK(13);\n")),
        ("(xv[j].w > 0.0f ? 1.0f : 0.0f));\n      }\n<@>      continue;\n",
         ("      CLK(14);\n",)),
        ("        d = d2;\n      }\n    }\n<@>  }\n", ("    CLK(14);\n",)),
        ("    A.stat_part[(size_t)blockIdx.x * N_UPSTATS + tid] = s;\n  }\n"
         "<@>}\n", ("  CLK(15);\n",))]),
]


def probe(src: str, trees):
    """The source with its probes, and the phase names of its tree: a dict
    {counter: name} (a list of names counts from 0)."""
    for names, anchors in trees:
        pieces = [(anchor.split("<@>"), (text,) if "<@>" not in anchor
                   else text) for anchor, text in anchors]
        if any(src.count("".join(p)) != 1 for p, _ in pieces):
            continue
        for p, texts in pieces:
            marked = p[0] + "".join(t + q for t, q in zip(texts, p[1:]))
            if len(p) == 1:
                marked = p[0] + texts[0]
            src = src.replace("".join(p), marked)
        return src, (names if isinstance(names, dict)
                     else dict(enumerate(names)))
    raise SystemExit("no known tree's anchors are each in the source once")


tmp = Path(tempfile.mkdtemp())
shutil.copytree(checkout / "drone_tpu_torch" / "csrc", tmp / "csrc")
(tmp / "probes.cuh").write_text(PROBES)
names, libs = {}, {}
splits = {"mlp": SPLITS, "tower": TOWER_KERNELS,
          "walk": {"update_lstm": WALK}}[which]
if which == "tower":
    header = tmp / "csrc" / "cnn_mma.cuh"
    text, tile_names = probe(header.read_text(), TOWER_TILES)
    header.write_text(text)
for name, trees in splits.items():
    path = tmp / "csrc" / f"{name}.cu"
    text, names[name] = probe(path.read_text(), trees)
    if which == "tower":
        names[name] = {**tile_names, **names[name]}
    path.write_text(text)
    lib = tmp / f"{name}.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                    "-include", str(tmp / "probes.cuh"), "-o", str(lib),
                    str(path)], check=True, capture_output=True, text=True)
    libs[name] = ctypes.CDLL(str(lib))
    cuda_build._loaded[name] = libs[name]  # the wrappers launch the copy

import torch  # noqa: E402

from drone_tpu_torch.env import DroneEnv  # noqa: E402
from drone_tpu_torch.ops import cuda_acting, cuda_acting_traj  # noqa: E402
from drone_tpu_torch.ops import cuda_update  # noqa: E402
from drone_tpu_torch.ops import cuda_update_cnn as K10  # noqa: E402
from drone_tpu_torch.ops import cuda_update_lstm as K7  # noqa: E402
from drone_tpu_torch.utils.config import Config  # noqa: E402

cfg = Config.from_toml(str(checkout / "configs" / "hover.toml"))
statics, params = cfg.env.build()
env = DroneEnv(statics.task, statics.integrator, params, device="cuda")
if which == "mlp":
    model = cs.flat_policy()
    planes, advret, perm_mb, co, rbl = cs.hover_minibatch(cfg, model, env)
    policy = cs.seeded_policy(seed=1).cuda()
    state = env.init_batch(2, 65536)
    runs = {
        "update": lambda: cuda_update.ppo_update_kernel(
            planes, advret, perm_mb, model.flat, model.hidden, co, rbl,
            0.001),
        "update bf16": lambda: cuda_update.ppo_update_kernel(
            planes, advret, perm_mb, model.flat, model.hidden, co, rbl,
            0.001, compute_dtype=cs.BF16),
        "acting": lambda: cuda_acting.act_rollout_kernel(
            state, policy, env.params, env.statics,
            int(env.params.horizon) + 1),
        "acting_traj": lambda: cuda_acting_traj.traj_rollout_kernel(
            state, model.flat, model.hidden, env.params, env.statics, 64),
        "acting_traj bf16": lambda: cuda_acting_traj.traj_rollout_kernel(
            state, model.flat, model.hidden, env.params, env.statics, 64,
            compute_dtype=cs.BF16),
    }
elif which == "tower":  # each bf16 update on one full-width minibatch
    cm = cs.cnn_policy(seed=2, log_std=0.0)
    k10 = cs.cnn_minibatch(cfg.with_overrides(list(cs.CNN_OVERRIDES)), cm,
                           env, cs.BF16)
    clm = cs.cnn_lstm_policy()
    k7 = cs.lstm_minibatch(cfg.with_overrides(list(cs.CNN_LSTM_OVERRIDES)),
                           clm, env)
    runs = {
        "update_cnn": lambda: K10.ppo_cnn_update_kernel(
            *k10[:3], cm.flat, cm.arch, *k10[3:], 0.001,
            compute_dtype=cs.BF16),
        "update_lstm": lambda: K7.lstm_update_kernel(
            *k7[:4], clm.flat, (clm.hidden, clm.encoder), *k7[4:], 0.001,
            compute_dtype=cs.BF16),
    }
else:  # K7's bf16 arms, each on one full-width minibatch of its path
    runs = {}
    for arm, m, over in (
            ("dense", cs.lstm_policy(), cs.LSTM_OVERRIDES),
            ("cnn", cs.cnn_lstm_policy(), cs.CNN_LSTM_OVERRIDES)):
        mb = cs.lstm_minibatch(cfg.with_overrides(list(over)), m, env)
        runs[arm] = (lambda mb=mb, m=m: K7.lstm_update_kernel(
            *mb[:4], m.flat, (m.hidden, m.encoder), *mb[4:], 0.001,
            compute_dtype=cs.BF16))
out = {}
for name, run in runs.items():
    lib_name = "update_lstm" if which == "walk" else name.split()[0]
    lib = libs[lib_name]
    run()
    torch.cuda.synchronize()
    lib.drone_clk_zero()
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 32)()
    if lib.drone_clk_read(buf) != 0:
        raise SystemExit(f"{name}: reading the counters failed")
    # a source's tree may probe several kernels: the phases this run read
    cycles = {n: int(buf[i]) for i, n in names[lib_name].items()
              if buf[i] or which != "mlp"}
    if which != "tower":
        total = sum(cycles.values())
        out[name] = {"cycles": cycles, "total": total,
                     "share": {n: c / total for n, c in cycles.items()}}
    else:  # each tile's phases as shares of its kernel's whole time
        out[name] = {}
        for part, lo, hi in (("fwd", 0, 7), ("bwd", 8, 15)):
            total = int(buf[hi])
            ph = {names[name][i]: int(buf[i]) for i in range(lo, hi)
                  if i in names[name]}
            ph[f"{part} outside the tile"] = total - sum(ph.values())
            out[name][part] = {"cycles": ph, "total": total,
                               "share": {n: c / total if total else 0.0
                                         for n, c in ph.items()}}
    print(f"{label} {name}: {out[name]}", flush=True)
print(json.dumps({"tree": label, "device": cs.device_line(), "split": out}),
      flush=True)
shutil.rmtree(tmp)
