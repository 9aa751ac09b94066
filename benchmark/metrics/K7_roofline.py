"""K7_roofline: the LSTM truncated-BPTT minibatch update
(csrc/update_lstm.cu: the gate fragments' packing, one walk and the
weight products a segment, the reduce once a call) against its least
time."""


def read(view):
    if view.entry != "train":
        return None
    return view.roofline("K7", "drone::lstm_reduce_kernel",
                         own=("drone::bptt_kernel", "drone::grad_mma_kernel",
                              "drone::pack_gates_t_kernel"),
                         shared=("drone::pack_gates_kernel",))
