"""gae_ms.train: device time from the trainer's `gae` mark to its `update`
mark (CUDA events at `on_phase`), the mean over the window's updates (ms):
GAE's queued ops and the device's wait for them."""


def read(view):
    return view.phase_ms("gae") if view.entry == "train" else None
