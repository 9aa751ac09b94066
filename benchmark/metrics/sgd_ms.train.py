"""sgd_ms.train: device time from the trainer's `update` mark to its
`metrics` mark, the mean over the window's updates (ms): every epoch's
minibatches through the update kernel and K4."""


def read(view):
    return view.phase_ms("update") if view.entry == "train" else None
