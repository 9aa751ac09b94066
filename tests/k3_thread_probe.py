"""How close the plain K3 comes to the reference's tolerance under several
torch thread counts: the case of
test_torch_update.py::test_plain_update_matches_reference, repeated.

    JAX_PLATFORMS=cpu python -m tests.k3_thread_probe <label> [repeats]

from the repo root. It builds the case's fixture and the reference's
update once, then runs the plain K3 `repeats` times (default 50) under
torch.set_num_threads(n) for n in 1, 2, 3, 6 and the CPU count, and prints
for each n the worst ratio of |difference| to atol + rtol |ref| over the
gradients and over the stat sums (the test's tolerances), the elements
that set them, and how many results differ bitwise from the first one at
1 thread. Thread settings outside torch (the CPUs the process may use,
which XLA's thread pool follows; MKL_DYNAMIC; XLA_FLAGS;
ATEN_CPU_CAPABILITY) are set from the shell. Not collected by pytest.
"""
import os
import sys

from tests import conftest  # noqa: F401  (the suite's XLA flags, CPU)
import jax.numpy as jnp
import numpy as np
import torch

from drone_tpu.ops import pallas_acting_traj as PAT
from drone_tpu.ops import pallas_update as PU
from drone_tpu.ops.pallas_acting import actor_weights
from tests import test_torch_update as T


def worst(got, ref, atol, rtol=2e-4):
    """(the worst |got - ref| / (atol + rtol |ref|), (its index, got,
    ref))."""
    r = np.abs(got - ref) / (atol + rtol * np.abs(ref))
    i = int(r.argmax())
    return float(r[i]), (i, float(got[i]), float(ref[i]))


def main(label: str, repeats: int) -> None:
    params, planes, advret, co, model = T._fixture()
    perm = np.array([5, 2, 7, 0], np.int32)  # the test's minibatch
    (ga, gc), st = PU.ppo_update(
        jnp.asarray(planes), jnp.asarray(advret), jnp.asarray(perm),
        actor_weights(params), PAT.critic_weights(params),
        PAT._log_std(params), tc=4, co=co, mode="reference")
    ref_g, ref_s = T._reference_flat_grads(ga, gc, st), np.asarray(st)
    first = None
    for n in (1, 2, 3, 6, os.cpu_count()):
        torch.set_num_threads(n)
        wg = ws = (0.0, None)
        differ = 0
        for _ in range(repeats):
            g, s = T.ppo_update_cuda(
                T._flat_np(planes), T._flat_np(advret),
                torch.from_numpy(perm), model.flat, T.HIDDEN,
                T._port_consts(co), rbl=128)
            g, s = g.numpy(), s.numpy()
            first = g.copy() if first is None else first
            differ += not np.array_equal(g.view(np.int32),
                                         first.view(np.int32))
            wg = max(wg, worst(g, ref_g, 1e-7), key=lambda w: w[0])
            ws = max(ws, worst(s, ref_s, 2e-6), key=lambda w: w[0])
        print(f"{label} threads={n} repeats={repeats}: worst gradient ratio "
              f"{wg[0]:.4f} at (index, got, ref) {wg[1]}; worst stat ratio "
              f"{ws[0]:.4f} at {ws[1]}; results differing bitwise from the "
              f"first at 1 thread: {differ}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 50)
