"""K6_roofline: the LSTM trajectory rollout (csrc/acting_lstm.cu
lstm_act_kernel, with the gate fragments' packing it shares with K7)
against its least time."""


def read(view):
    if view.entry != "train":
        return None
    return view.roofline("K6", "drone::lstm_act_kernel",
                         shared=("drone::pack_gates_kernel",))
