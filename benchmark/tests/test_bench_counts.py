"""The products and bytes the rooflines and mfu divide by, against counts
by hand at the two configurations' widths."""

import pytest

from benchmark.harness import spec as S


def _counts(config, cell):
    bench = S.load_spec()
    tables = S.config_tables(S.ROOT / S.config_entry(bench, config)["file"])
    return S.counts(config).counts(tables, S.workload_file(cell))


def test_mlp_hover_by_hand():
    kernels, step = _counts("mlp_hover", "mlp_hover.eval")
    actor = 13 * 64 + 64 * 64 + 64 * 4          # 5,184 multiply-adds
    critic = 13 * 64 + 64 * 64 + 64 * 1         # 4,992
    fwd = 2 * (actor + critic)                  # 20,352 FLOPs
    dx = 2 * (64 * 64 + 64 * 4 + 64 * 64 + 64)  # no input gradient of obs
    update = 2 * fwd + dx                       # 57,728
    params = 14 * 64 + 65 * 64 + 65 * 4 + 14 * 64 + 65 * 64 + 65 + 4
    assert params == 10441
    assert step["train"] == fwd + 4 * update + 2 * critic / 64 == 251420
    assert step["eval"] == 2 * actor == 10368
    assert kernels["K2"]["flops"] == 65536 * 64 * fwd == 85_362_475_008
    assert kernels["K2"]["bytes"] == 4 * (params + 65536 * (25 + 25 + 5)
                                          + 64 * 65536 * 21)
    mb = 65536 * 64 // 8
    assert kernels["K3"]["flops"] == mb * update == 30_266_097_664
    assert kernels["K3"]["bytes"] == 4 * (mb * 21 + 2 * params + 8)
    assert kernels["K4"] == {"flops": 0, "bytes": 4 * 7 * params}
    assert kernels["K5"]["flops"] == 65536 * 1001 * 2 * actor


def test_lstm_hover_by_hand():
    kernels, step = _counts("lstm_hover", "lstm_hover.eval")
    H, E = 128, 64
    cell = 13 * E + 4 * H * (E + H)             # 99,136 multiply-adds
    fwd = 2 * (cell + 5 * H)                    # 199,552 FLOPs
    dx = 2 * (5 * H + 4 * H * (E + H))          # heads and gates, not obs
    update = 2 * fwd + dx                       # 596,992
    params = 14 * E + 4 * H * E + 4 * H * H + 4 * H + 129 * 5 + 4
    assert params == 100361
    assert step["train"] == pytest.approx(fwd + 4 * update
                                          + 2 * (cell + H) / 128)
    assert step["eval"] == 2 * (cell + 4 * H) == 199296
    assert kernels["K6"]["flops"] == 65536 * 128 * fwd
    assert kernels["K6"]["bytes"] == 4 * (
        params + 65536 * (25 + 25 + 5 + 4 * H) + 128 * 65536 * 21
        + 8 * 2 * H * 65536)
    mb_lanes = 65536 // 4
    assert kernels["K7"]["flops"] == mb_lanes * 128 * update
    assert kernels["K7"]["bytes"] == 4 * (mb_lanes * 128 * 21
                                          + 8 * 2 * H * mb_lanes
                                          + 2 * params + 8)
    assert kernels["K4"]["bytes"] == 4 * 7 * params
    assert kernels["K8"]["flops"] == 65536 * 1001 * 2 * (cell + 4 * H)


@pytest.mark.parametrize("config,cell", [("mlp_hover", "mlp_hover.train"),
                                         ("lstm_hover", "lstm_hover.train")])
def test_counts_grow_with_the_batch(config, cell):
    bench = S.load_spec()
    tables = S.config_tables(S.ROOT / S.config_entry(bench, config)["file"])
    wl = S.workload_file(cell)
    k1, _ = S.counts(config).counts(tables, wl)
    tables["train"]["num_envs"] *= 2
    k2, s2 = S.counts(config).counts(tables, wl)
    for k in k1:
        if k != "K4":
            assert k2[k]["flops"] == 2 * k1[k]["flops"]
    assert s2["train"] > 0
