"""The rollout dumper behind `cli watch` (counterpart of the reference's
`viz/viewer.py` `dump_rollout` and of its `cli watch` rollout).

`dump_rollout` steps one lane of the env on its device and writes the CSV
schema of `native/demo.c` and the reference's dumper (t, x, y, z, tx, ty,
tz, reward, done; positions and reward to four decimals), one device-to-host
copy of the lane's few floats a step. `watch_rollout` restores the latest
checkpoint of a config and writes that CSV of its policy's deterministic
mean; `viz.viewer.render` and `render_gif` (matplotlib) draw it.

One change from the reference: both recurrent families take the carry path
(the carry zeroed where an episode ended, as in training and evaluation);
the reference routes only run.policy=lstm there and fails on cnn_lstm.
"""

from __future__ import annotations

import torch

CSV_HEADER = "t,x,y,z,tx,ty,tz,reward,done\n"


def dump_rollout(env, params, policy_fn, steps, out_csv, seed=0):
    """Roll one lane (lane 0 of `seed`) for `steps` steps and write its
    trajectory to out_csv. policy_fn(obs, done) -> action, obs the lane's
    (1, 13) observation on the env's device; `done` is 1 when the PREVIOUS
    step ended an episode (the env has auto-reset), so a recurrent policy
    can zero its carry as the training and evaluation paths do. Returns
    out_csv."""
    state = env.init(seed, 0, params=params)
    obs = env.observe(state)
    done = 0
    with open(out_csv, "w") as f:
        f.write(CSV_HEADER)
        for t in range(steps):
            a = policy_fn(obs, done)
            state, out = env.step(state, a, params)
            obs = out.obs
            row = torch.cat([
                state.pos[0], state.target[0], out.reward,
                (out.terminated | out.truncated).to(torch.float32)]).cpu()
            p, tg = row[:3].tolist(), row[3:6].tolist()
            done = int(row[7])
            f.write(f"{t},{p[0]:.4f},{p[1]:.4f},{p[2]:.4f},"
                    f"{tg[0]:.4f},{tg[1]:.4f},{tg[2]:.4f},"
                    f"{float(row[6]):.4f},{done}\n")
    return out_csv


def policy_of(model, recurrent: bool, device):
    """policy_fn(obs, done) of `model`'s deterministic mean: through the
    carry for a recurrent model (zeroed when done), else the feed-forward
    forward."""
    if not recurrent:
        return lambda obs, done: model(obs)[0]
    carry = [model.initial_carry(1, device)]

    def policy_fn(obs, done):
        if done:  # episode boundary: zero the carry, as in training
            carry[0] = model.initial_carry(1, device)
        mean, _, _, carry[0] = model(obs, carry[0])
        return mean

    return policy_fn


@torch.no_grad()
def watch_rollout(cfg, csv_path, steps: int = 0, device="cuda"):
    """`cli watch` without the render: the latest checkpoint of
    `train.restore_dir(cfg)` rolled out on `device` for `steps` steps (the
    env's horizon when 0) into csv_path. Returns the racing gates to draw,
    [(x, y, z), ...], or None for another task."""
    from drone_tpu_torch.train import (
        _RECURRENT,
        _check_cnn_checkpoint_layout,
        build_env_and_model,
        restore_dir,
    )
    from drone_tpu_torch.utils.checkpoint import Checkpointer

    # the shared factory: watch renders the model training built
    env, model = build_env_and_model(cfg, device)
    raw, _ = Checkpointer(restore_dir(cfg)).restore_raw()
    _check_cnn_checkpoint_layout(cfg, raw["params"])
    model.load_state_dict(raw["params"])
    model.eval()
    policy_fn = policy_of(model, cfg.run.policy in _RECURRENT, env.device)
    dump_rollout(env, env.params, policy_fn,
                 steps or int(env.params.horizon), csv_path,
                 seed=cfg.run.seed)
    if env.statics.task != "racing":
        return None
    g = env.params.gates[:int(env.params.n_gates)].cpu()
    return [tuple(map(float, row)) for row in g.tolist()]
