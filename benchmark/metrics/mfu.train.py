"""mfu.train: the model FLOPs of the traced window's updates (a sample's
rollout forward, every epoch's forward and backward, the last value) over
the peak of the configuration's precision for the window's length (%)."""


def read(view):
    return view.mfu() if view.entry == "train" else None
