"""K8_roofline: the LSTM acting kernel of evaluate() (csrc/acting_lstm.cu
lstm_act_kernel and its gate fragments' packing) against its least
time."""


def read(view):
    if view.entry != "eval":
        return None
    return view.roofline("K8", "drone::lstm_act_kernel",
                         shared=("drone::pack_gates_kernel",))
