"""mfu.eval: the policy forward's FLOPs of every env step of the traced
window's evaluate() calls over the peak for the window's length (%)."""


def read(view):
    return view.mfu() if view.entry == "eval" else None
