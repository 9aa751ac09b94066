"""K2_roofline: the MLP trajectory rollout (csrc/acting_traj.cu: the
weights' packing and traj_kernel, once a call) against its least time."""


def read(view):
    if view.entry != "train":
        return None
    return view.roofline("K2", "drone::traj_kernel",
                         own=("drone::pack_traj_kernel",))
