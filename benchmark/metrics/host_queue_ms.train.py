"""host_queue_ms.train: the host clock from a step call to its return,
the mean over the window's updates (ms): the time the host takes to queue
an update, which the device hides while it is shorter than the update."""


def read(view):
    if view.entry != "train" or not view.host_queue_s:
        return None
    return 1e3 * sum(view.host_queue_s) / len(view.host_queue_s)
