"""Times and registers of the MLP, LSTM, CNN and CNN-LSTM kernels of a
checkout.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/kernel_times.py <label> [mlp]

It builds rollout, acting, acting_traj, update, acting_lstm, update_lstm,
acting_cnn and update_cnn, times K2 (65,536 lanes x 64 steps) on
hover.toml's [64, 64] tower, K3 on its full-width minibatch and K4 over
its parameters (and, near the end, over the CNN-LSTM's 226,697: "K4
cnn_lstm"; each also by its device time in a torch.profiler trace, "K4
device"), then K1 on hover.toml's env (65,536 x 1,001 and 131,072 x
4,096 with in-kernel actions, 65,536 x 64 with provided ones), then
K5 (65,536 x 1,001; after the short MLP kernels, which its seconds of
load would slow), K8 and K6 (dense encoder and CNN arm) and K11
and K9 at their paths' shapes, and K7 (both arms) and K10 on one
full-width minibatch, by CUDA events (and, where the checkout has them, the
bf16 arms on the same inputs: "K2 bf16", "K3 bf16", "K7 bf16", "K7 cnn
bf16", "K9 bf16", "K10 bf16"), then one warm
MLP update of hover.toml split into its phases (chip_smoke.split_update,
which also prints its profiler trace), and prints one JSON line with the
ptxas register count of every kernel. With `mlp` it times the MLP
kernels alone (K2, K3, K4 and K5, each arm), then one warm MLP update of
each arm ("MLP update ..." and "MLP bf16 update ..."). K7
dense is read first and again last, on the same inputs ("K7" and "K7
end"), so a drift of the card within one run shows beside the others. To
compare two commits, copy the script into a second checkout (git archive)
and run both in one call, in turns (parent, change, change, parent).
"""
import inspect
import json
import sys

sys.path.insert(0, ".")  # the checkout it runs from

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from drone_tpu_torch import prng  # noqa: E402
from drone_tpu_torch.env import DroneEnv  # noqa: E402
from drone_tpu_torch.models import kernel_order, tensor_sizes  # noqa: E402
from drone_tpu_torch.ops import cuda_acting as K5  # noqa: E402
from drone_tpu_torch.ops import cuda_acting_traj as K2  # noqa: E402
from drone_tpu_torch.ops import cuda_acting_cnn as K11  # noqa: E402
from drone_tpu_torch.ops import cuda_acting_lstm as K8  # noqa: E402
from drone_tpu_torch.ops import cuda_build  # noqa: E402
from drone_tpu_torch.ops import cuda_rollout as K1  # noqa: E402
from drone_tpu_torch.ops import cuda_update as K3  # noqa: E402
from drone_tpu_torch.ops import cuda_update_cnn as K10  # noqa: E402
from drone_tpu_torch.ops import cuda_update_lstm as K7  # noqa: E402
from drone_tpu_torch.utils.config import Config  # noqa: E402

mlp_only = sys.argv[2:] == ["mlp"]
libs = cuda_build.build(("acting", "acting_traj", "update") if mlp_only else
                        ("rollout", "acting", "acting_traj", "update",
                         "acting_lstm", "update_lstm", "acting_cnn",
                         "update_cnn"))
regs = {}
for name, lib in libs.items():
    entry = None
    for line in lib.with_suffix(".so.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1][:48]
        if "Used " in line:
            regs[f"{name}:{entry}"] = int(line.split("Used ")[1].split()[0])


def device_ms(fn, reps, key):
    """The device time of one call of fn: the kernels whose name holds key
    in a torch.profiler trace of reps calls (a short kernel's CUDA-event
    time is its launch rate: the host's wrapper takes longer)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if key in e.key) / reps / 1e3


cfg = Config.from_toml("configs/hover.toml")
statics, params = cfg.env.build()
env = DroneEnv(statics.task, statics.integrator, params, device="cuda")
n, horizon = 65536, int(env.params.horizon) + 1
t = {}
state = env.init_batch(2, n)
model = cs.flat_policy()
t["K2"] = cs.cuda_ms(lambda: K2.traj_rollout_kernel(
    state, model.flat, model.hidden, env.params, env.statics, 64), 5)
# the bf16 arms of K2 and K3, where this checkout has them
mlp_bf16 = "compute_dtype" in inspect.signature(
    K3.ppo_update_kernel).parameters
if mlp_bf16:
    t["K2 bf16"] = cs.cuda_ms(lambda: K2.traj_rollout_kernel(
        state, model.flat, model.hidden, env.params, env.statics, 64,
        compute_dtype=cs.BF16), 5)
planes, advret, perm_mb, co, rbl = cs.hover_minibatch(cfg, model, env)
t["K3"] = cs.cuda_ms(lambda: K3.ppo_update_kernel(
    planes, advret, perm_mb, model.flat, model.hidden, co, rbl, 0.001), 20)
if mlp_bf16:
    t["K3 bf16"] = cs.cuda_ms(lambda: K3.ppo_update_kernel(
        planes, advret, perm_mb, model.flat, model.hidden, co, rbl, 0.001,
        compute_dtype=cs.BF16), 20)
del planes, advret
adam = [model.flat.clone(), 0.05 * torch.ones_like(model.flat),
        torch.zeros_like(model.flat), torch.zeros_like(model.flat),
        torch.zeros((), device="cuda"), K3.AdamConsts(),
        K3.LrSchedule(3e-4, 1000, True),
        tensor_sizes(kernel_order(model.hidden))]
t["K4"] = cs.cuda_ms(lambda: K3.fused_adam_kernel(*adam), 100)
t["K4 device"] = device_ms(lambda: K3.fused_adam_kernel(*adam), 100,
                           "adam_kernel")
k1_cases = () if mlp_only else (
    (65536, 1001, None), (131072, 4096, None),
    (65536, 64, torch.from_numpy(prng.action_stream_np(64, 65536, seed=3))
     .cuda()))
for k1_n, k1_T, k1_acts in k1_cases:
    k1_state = env.init_batch(0, k1_n)
    t[f"K1 {k1_n} x {k1_T}{' provided' if k1_acts is not None else ''}"] = \
        cs.cuda_ms(lambda: K1.rollout_kernel(k1_state, env.params, env.statics,
                                             k1_T, k1_acts),
                   10 if k1_T < 4096 else 4)
if k1_cases:
    del k1_state
mlp = cs.seeded_policy(seed=1).cuda()
t["K5"] = cs.cuda_ms(lambda: K5.act_rollout_kernel(
    state, mlp, env.params, env.statics, horizon), 5)
if mlp_only:
    t.update({f"MLP update {k}": v for k, v in cs.split_update(cfg).items()})
    if mlp_bf16:
        t.update({f"MLP bf16 update {k}": v for k, v in cs.split_update(
            cfg.with_overrides([f"run.compute_dtype={cs.BF16}"])).items()})
    print(json.dumps({"tree": sys.argv[1], "device": cs.device_line(),
                      "ms": t, "regs": regs}), flush=True)
    sys.exit(0)
lm = cs.lstm_policy()
planes, advret, snap, perm_mb, co, rbl, bptt = cs.lstm_minibatch(
    cfg.with_overrides(list(cs.LSTM_OVERRIDES)), lm, env)
k7_args = (planes, advret, snap, perm_mb, lm.flat, (lm.hidden, lm.encoder),
           co, rbl, bptt, 0.001)
t["K7"] = cs.cuda_ms(lambda: K7.lstm_update_kernel(*k7_args), 5)
# K7's bf16 arm, where this checkout has one
bf16 = "compute_dtype" in inspect.signature(K7.lstm_update_kernel).parameters
if bf16:
    t["K7 bf16"] = cs.cuda_ms(lambda: K7.lstm_update_kernel(
        *k7_args, compute_dtype="bfloat16"), 5)
model = cs.lstm_policy(seed=2, log_std=0.0)
arch = (model.hidden, model.encoder)
state, s9 = env.init_batch(1, n), env.init_batch(9, n)
carry = model.initial_carry(n, "cuda")
t["K8"] = cs.cuda_ms(lambda: K8.lstm_act_rollout_kernel(
    state, model.flat, arch, carry, env.params, env.statics, horizon), 3)
t["K6"] = cs.cuda_ms(lambda: K8.traj_lstm_rollout_kernel(
    s9, model.flat, arch, carry, env.params, env.statics, 128, 16), 5)
cm = cs.cnn_policy(seed=2, log_std=0.0)
t["K11"] = cs.cuda_ms(lambda: K11.cnn_act_rollout_kernel(
    state, cm.flat, cm.arch, env.params, env.statics, horizon), 1)
t["K9"] = cs.cuda_ms(lambda: K11.traj_cnn_rollout_kernel(
    s9, cm.flat, cm.arch, env.params, env.statics, 128), 3)
# the bf16 arms of the CNN kernels, where this checkout has them
cnn_bf16 = "compute_dtype" in inspect.signature(
    K10.ppo_cnn_update_kernel).parameters
if cnn_bf16:
    t["K9 bf16"] = cs.cuda_ms(lambda: K11.traj_cnn_rollout_kernel(
        s9, cm.flat, cm.arch, env.params, env.statics, 128,
        compute_dtype=cs.BF16), 3)
planes, advret, perm_mb, co, rbl = cs.cnn_minibatch(
    cfg.with_overrides(list(cs.CNN_OVERRIDES)), cm, env)
t["K10"] = cs.cuda_ms(lambda: K10.ppo_cnn_update_kernel(
    planes, advret, perm_mb, cm.flat, cm.arch, co, rbl, 0.001), 3)
if cnn_bf16:
    t["K10 bf16"] = cs.cuda_ms(lambda: K10.ppo_cnn_update_kernel(
        planes, advret, perm_mb, cm.flat, cm.arch, co, rbl, 0.001,
        compute_dtype=cs.BF16), 3)
del planes, advret
clm = cs.cnn_lstm_policy(seed=2, log_std=0.0)
arch = (clm.hidden, clm.encoder)
carry = clm.initial_carry(n, "cuda")
t["K8 cnn"] = cs.cuda_ms(lambda: K8.lstm_act_rollout_kernel(
    state, clm.flat, arch, carry, env.params, env.statics, horizon), 1)
t["K6 cnn"] = cs.cuda_ms(lambda: K8.traj_lstm_rollout_kernel(
    s9, clm.flat, arch, carry, env.params, env.statics, 128, 16), 2)
clm = cs.cnn_lstm_policy()
planes, advret, snap, perm_mb, co, rbl, bptt = cs.lstm_minibatch(
    cfg.with_overrides(list(cs.CNN_LSTM_OVERRIDES)), clm, env)
args = (planes, advret, snap, perm_mb, clm.flat, (clm.hidden, clm.encoder),
        co, rbl, bptt, 0.001)
t["K7 cnn"] = cs.cuda_ms(lambda: K7.lstm_update_kernel(*args), 3)
if bf16:
    t["K7 cnn bf16"] = cs.cuda_ms(lambda: K7.lstm_update_kernel(
        *args, compute_dtype="bfloat16"), 3)
del planes, advret, snap, args
adam = [clm.flat.clone(), 0.05 * torch.ones_like(clm.flat),
        torch.zeros_like(clm.flat), torch.zeros_like(clm.flat),
        torch.zeros((), device="cuda"), K3.AdamConsts(),
        K3.LrSchedule(3e-4, 1000, True), tensor_sizes(clm.kernel_order())]
t["K4 cnn_lstm"] = cs.cuda_ms(lambda: K3.fused_adam_kernel(*adam), 100)
t["K4 cnn_lstm device"] = device_ms(lambda: K3.fused_adam_kernel(*adam),
                                    100, "adam_kernel")
t["K7 end"] = cs.cuda_ms(lambda: K7.lstm_update_kernel(*k7_args), 5)
del k7_args
t.update({f"MLP update {k}": v for k, v in cs.split_update(cfg).items()})
print(json.dumps({"tree": sys.argv[1], "device": cs.device_line(), "ms": t,
                  "regs": regs}), flush=True)
