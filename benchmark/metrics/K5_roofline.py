"""K5_roofline: the MLP acting kernel of evaluate() (csrc/acting.cu
act_kernel) against its least time."""


def read(view):
    if view.entry != "eval":
        return None
    return view.roofline("K5", "drone::act_kernel")
