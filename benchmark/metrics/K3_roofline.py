"""K3_roofline: the MLP PPO minibatch update (csrc/update.cu: the weight
planes' packing, update_kernel and the partials' reduce_kernel, once a
call) against its least time."""


def read(view):
    if view.entry != "train":
        return None
    return view.roofline("K3", "drone::reduce_kernel",
                         own=("drone::update_kernel",
                              "drone::pack_planes_kernel"))
