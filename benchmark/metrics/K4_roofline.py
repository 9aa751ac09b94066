"""K4_roofline: clip_by_global_norm + Adam over the flat parameters
(csrc/update.cu adam_kernel) against its least time (its bytes)."""


def read(view):
    if view.entry != "train":
        return None
    return view.roofline("K4", "drone::adam_kernel")
