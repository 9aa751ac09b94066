"""idle_share.train: the share of the traced window of training updates in
which no kernel, memcpy or memset runs on the device (%)."""


def read(view):
    return view.idle_share() if view.entry == "train" else None
