"""EnvParams / EnvState / StepOut as dataclasses of tensors, plus static config.

Counterpart of `drone_tpu/types.py`. Every dynamic value is a float32 or
int32 tensor. The state is a structure of arrays with a leading lane axis
(where JAX vmapped a single-drone pytree). The uint32 fields of the state
(`reset_count`, `wp_count`, `key0`, `key1`) are stored as int32 tensors
holding the same bit pattern, so a CUDA kernel reads them as `uint32_t`
without a copy; `prng.to_u32` widens them for arithmetic on the host.

Env params live as tensors on the state's device, never as Python floats:
on CUDA, torch divides by a CPU scalar through its reciprocal, which breaks
the bitwise contract with the C oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

OBS_DIM = 13  # target-relative pos(3) + quat(4) + vel(3) + omega(3)
ACT_DIM = 4   # one command in [-1, 1] per rotor
MAX_GATES = 8
RESET_BLOCKS = 9   # threefry blocks consumed per reset (18 uniforms, 17 used)
WP_BLOCK0 = 16     # waypoint respawn draws: blocks WP_BLOCK0 + 2*wp_count, +1

TASKS = ("hover", "waypoint", "racing")
INTEGRATORS = ("euler", "rk4")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; a missing card is an error, never a quiet CPU run."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return d


@dataclasses.dataclass(frozen=True)
class EnvStatics:
    """Static env configuration (task, integrator). Hashable."""

    task: str = "hover"
    integrator: str = "euler"

    def __post_init__(self):
        if self.task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {self.task!r}")
        if self.integrator not in INTEGRATORS:
            raise ValueError(
                f"integrator must be one of {INTEGRATORS}, got {self.integrator!r}"
            )

    @property
    def task_id(self) -> int:
        return TASKS.index(self.task)

    @property
    def integrator_id(self) -> int:
        return INTEGRATORS.index(self.integrator)


class _TensorFields:
    """Field-wise device move shared by the tensor dataclasses."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class EnvParams(_TensorFields):
    """All physical and task constants. Scalars are 0-d float32 tensors
    (int32 for horizon and n_gates); target is (3,), gates (MAX_GATES, 3)."""

    mass: torch.Tensor
    gravity: torch.Tensor
    arm_l: torch.Tensor
    thrust_max: torch.Tensor
    torque_coef: torch.Tensor
    inertia_x: torch.Tensor
    inertia_y: torch.Tensor
    inertia_z: torch.Tensor
    drag_lin: torch.Tensor
    drag_ang: torch.Tensor
    dt: torch.Tensor
    target: torch.Tensor
    bound: torch.Tensor
    tilt_min: torch.Tensor
    horizon: torch.Tensor
    c_vel: torch.Tensor
    c_spin: torch.Tensor
    c_act: torch.Tensor
    crash_penalty: torch.Tensor
    reach_bonus: torch.Tensor
    reach_tol2: torch.Tensor
    pos_radius: torch.Tensor
    vel_max_init: torch.Tensor
    rot_max_init: torch.Tensor
    omega_max_init: torch.Tensor
    dr_mass_lo: torch.Tensor
    dr_mass_hi: torch.Tensor
    dr_thrust_lo: torch.Tensor
    dr_thrust_hi: torch.Tensor
    wp_box: torch.Tensor
    wp_zmin: torch.Tensor
    wp_zmax: torch.Tensor
    gates: torch.Tensor
    n_gates: torch.Tensor


_INT_PARAMS = ("horizon", "n_gates")


def default_gates() -> np.ndarray:
    """4 gates on a square at z=1.5 (float32 exact constants, shared with C)."""
    g = np.zeros((MAX_GATES, 3), np.float32)
    g[0] = (2.0, 0.0, 1.5)
    g[1] = (0.0, 2.0, 1.5)
    g[2] = (-2.0, 0.0, 1.5)
    g[3] = (0.0, -2.0, 1.5)
    return g


def default_params(task: str = "hover", device="cpu", **overrides) -> EnvParams:
    """The same float32 defaults as `drone_tpu.types.default_params`, as
    tensors on `device`. Overrides take any EnvParams field."""
    base = dict(
        mass=0.75,
        gravity=9.81,
        arm_l=0.08,
        thrust_max=4.6,
        torque_coef=0.016,
        inertia_x=0.0023,
        inertia_y=0.0023,
        inertia_z=0.004,
        drag_lin=0.10,
        drag_ang=0.003,
        dt=0.01,
        target=[0.0, 0.0, 1.5],
        bound=5.0,
        tilt_min=0.0,
        horizon=1500 if task == "waypoint" else 1000,
        c_vel=0.02,
        c_spin=0.01,
        c_act=0.01,
        crash_penalty=-10.0,
        reach_bonus=10.0,
        reach_tol2=0.09,
        pos_radius=1.0,
        vel_max_init=0.5,
        rot_max_init=0.5,
        omega_max_init=0.5,
        dr_mass_lo=1.0,
        dr_mass_hi=1.0,
        dr_thrust_lo=1.0,
        dr_thrust_hi=1.0,
        wp_box=3.0,
        wp_zmin=0.8,
        wp_zmax=4.0,
        gates=default_gates(),
        n_gates=4,
    )
    base.update(overrides)
    return EnvParams(**{
        k: torch.as_tensor(np.asarray(
            v, np.int32 if k in _INT_PARAMS else np.float32)).to(device)
        for k, v in base.items()})


@dataclasses.dataclass
class EnvState(_TensorFields):
    """Per-lane state, leading axis N. uint32 fields hold their bits in int32."""

    pos: torch.Tensor        # (N, 3) world frame, m
    vel: torch.Tensor        # (N, 3) world frame, m/s
    quat: torch.Tensor       # (N, 4) (w, x, y, z), body->world
    omega: torch.Tensor      # (N, 3) body frame, rad/s
    target: torch.Tensor     # (N, 3) current target / active gate center
    dr_mass: torch.Tensor    # (N,) per-episode mass scale
    dr_thrust: torch.Tensor  # (N,) per-episode thrust scale
    ep_return: torch.Tensor  # (N,) running episode return
    step: torch.Tensor       # (N,) int32 step within episode
    reset_count: torch.Tensor  # (N,) uint32 bits: episode counter
    wp_count: torch.Tensor     # (N,) uint32 bits: waypoints reached
    gate_idx: torch.Tensor     # (N,) int32 active racing gate
    key0: torch.Tensor         # (N,) uint32 bits: lane key
    key1: torch.Tensor

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def select(self, mask: torch.Tensor, other: "EnvState") -> "EnvState":
        """Lane-wise `where(mask, self, other)`."""
        def pick(a, b):
            m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
            return torch.where(m, a, b)
        return EnvState(**{f.name: pick(getattr(self, f.name),
                                        getattr(other, f.name))
                           for f in dataclasses.fields(self)})

    def fstate(self) -> torch.Tensor:
        """(N, 19) float32 in the C oracle's fstate layout."""
        return torch.cat([self.pos, self.vel, self.quat, self.omega,
                          self.target, self.dr_mass[:, None],
                          self.dr_thrust[:, None], self.ep_return[:, None]], 1)


@dataclasses.dataclass
class StepOut:
    """Outputs of one batched env step (after any auto-reset)."""

    obs: torch.Tensor         # (N, OBS_DIM)
    reward: torch.Tensor      # (N,) reward of the step that just finished
    terminated: torch.Tensor  # (N,) bool, crash
    truncated: torch.Tensor   # (N,) bool, horizon
    ep_return: torch.Tensor   # (N,) nonzero only where an episode ended
    ep_length: torch.Tensor   # (N,) int32, nonzero only where an episode ended
