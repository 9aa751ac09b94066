"""idle_share.eval: the share of the traced window of evaluate() calls in
which no kernel, memcpy or memset runs on the device (%)."""


def read(view):
    return view.idle_share() if view.entry == "eval" else None
