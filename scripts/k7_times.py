"""K7's bf16 arms on one card: each arm's launch time and the device time
of each of its kernels (the walk, the products, the CNN arm's tower).

Run from the root of a checkout on a machine with an H100:

    python3 scripts/k7_times.py <label> [checkout]

It loads the drone_tpu_torch package of `checkout` (by default the one it
runs from; give a git archive of a parent commit, or an edited copy of a
checkout, to time that one's K7), makes one full-width minibatch of each
recurrent path (chip_smoke.lstm_minibatch: 65,536 envs x 128 steps, bptt
16, a quarter of the lanes; the dense encoder (64,) and the CNN arm, H
128), and times K7's bf16 arm on it by CUDA events (5 launches dense, 3
CNN, after a warm-up), then reads each kernel's device time from a
torch.profiler trace of 3 launches (ms a launch). It prints one line a
arm and one JSON line. To compare checkouts, run it in each in one call,
in turns (parent, change, change, parent).
"""
import json
import sys

label = sys.argv[1]
sys.path.insert(0, ".")  # the checkout it runs from

import chip_smoke as cs  # noqa: E402

if len(sys.argv) > 2:
    sys.path.insert(0, sys.argv[2])  # its package before this checkout's

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from drone_tpu_torch.env import DroneEnv  # noqa: E402
from drone_tpu_torch.ops import cuda_update_lstm as K7  # noqa: E402
from drone_tpu_torch.utils.config import Config  # noqa: E402

cfg = Config.from_toml("configs/hover.toml")
statics, params = cfg.env.build()
env = DroneEnv(statics.task, statics.integrator, params, device="cuda")
out = {}
for arm, m, over in (("dense", cs.lstm_policy(), cs.LSTM_OVERRIDES),
                     ("cnn", cs.cnn_lstm_policy(), cs.CNN_LSTM_OVERRIDES)):
    mb = cs.lstm_minibatch(cfg.with_overrides(list(over)), m, env)

    def run():
        return K7.lstm_update_kernel(*mb[:4], m.flat, (m.hidden, m.encoder),
                                     *mb[4:], 0.001, compute_dtype="bfloat16")

    out[arm] = cs.cuda_ms(run, 5 if arm == "dense" else 3)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    kernels = {e.key[:40]: round(e.device_time_total / 3 / 1e3, 4)
               for e in prof.key_averages() if e.device_time_total > 0}
    out[arm + " kernels"] = kernels
    print(label, arm, out[arm], kernels, flush=True)
    del mb
print(json.dumps({"tree": label, "device": cs.device_line(), "ms": out}),
      flush=True)
