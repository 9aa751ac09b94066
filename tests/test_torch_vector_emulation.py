"""drone_tpu_torch.vector, .emulation and .multiagent, and env.step_terminal,
against the reference on the CPU.

tests/test_vector_emulation.py ported: each test drives the port with
device="cpu" and the reference with the same seed and action stream
(tests.helpers.action_stream), and holds observations, rewards,
terminals, truncations and episode infos bitwise equal. Beside them:
step_terminal bitwise against drone_tpu.env.step_terminal on all three
tasks, and every adapter with gymnasium and pettingzoo hidden, the
duck-typed classes that run where neither is installed.
"""

import importlib
import sys

import jax
import numpy as np
import pytest
import torch

import drone_tpu
from drone_tpu import env as jenv
from drone_tpu import vector as jvector
from drone_tpu.emulation import DroneGymnasium as JaxGymnasium
from drone_tpu.emulation import DroneVectorGymnasium as JaxVectorGymnasium
from drone_tpu.multiagent import DroneSwarmParallel as JaxSwarm
from drone_tpu.types import default_params as jax_default_params
from drone_tpu_torch import emulation, multiagent, spaces, vector
from drone_tpu_torch import env as tenv
from drone_tpu_torch.types import default_params
from tests.helpers import action_stream, pack_fstate_batch

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bitwise(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert np.array_equal(bits(got), bits(want)), what


def assert_infos_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert_bitwise(got[k], want[k], k)


def drive(v, acts):
    """reset + step through `acts`: stacked obs (T+1), rewards, terminals,
    truncations, and the infos of each step."""
    obs, _ = v.reset()
    rows, rews, terms, truncs, infos = [obs.copy()], [], [], [], []
    for a in acts:
        o, r, te, tr, inf = v.step(a)
        rows.append(o.copy())
        rews.append(r.copy())
        terms.append(te.copy())
        truncs.append(tr.copy())
        infos.append({k: np.array(x) for k, x in inf.items()})
    return (np.stack(rows), np.stack(rews), np.stack(terms),
            np.stack(truncs)), infos


def assert_traces_equal(got, want):
    for g, w, name in zip(got[0], want[0], ("obs", "rew", "term", "trunc")):
        assert_bitwise(g, w, name)
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        assert_infos_equal(g, w)


def test_make_and_spaces():
    v = vector.make("hover", num_envs=4, **CPU)
    assert v.num_envs == 4
    assert v.single_observation_space.shape == (13,)
    assert v.single_action_space.shape == (4,)
    assert np.all(v.single_action_space.low == -1.0)
    obs, _ = v.reset(seed=0)
    assert obs.shape == (4, 13)
    assert obs is v.observations  # caller-visible preallocated buffer
    want, _ = jvector.make("hover", num_envs=4).reset(seed=0)
    assert_bitwise(obs, want)


def test_backend_equivalence_bitwise():
    """jit (batched) and serial (a loop of one-lane steps) produce identical
    batches, and both equal the reference's."""
    T, n = 25, 6
    acts = action_stream(T=T, n=n, seed=11)
    want = drive(jvector.make("waypoint", num_envs=n, seed=5), acts)
    for backend in vector.BACKENDS:
        got = drive(vector.make("waypoint", num_envs=n, backend=backend,
                                seed=5, **CPU), acts)
        assert_traces_equal(got, want)


def test_async_api_matches_sync():
    n = 4
    acts = action_stream(T=10, n=n, seed=3)
    v1 = vector.make("hover", num_envs=n, seed=9, **CPU)
    v2 = vector.make("hover", num_envs=n, seed=9, **CPU)
    ref = jvector.make("hover", num_envs=n, seed=9)
    v1.reset()
    ref.reset()
    v2.async_reset()
    # the canonical calling loop: recv() after async_reset returns initial obs
    o0, r0, t0, tr0, inf0 = v2.recv()
    assert np.array_equal(o0, v1.observations) and not inf0
    assert_bitwise(o0, ref.observations)
    with pytest.raises(RuntimeError):
        v2.recv()  # reset result consumed
    for t in range(10):
        o1, r1, *_ = v1.step(acts[t])
        v2.send(acts[t])
        o2, r2, te2, tr2, _ = v2.recv()
        ro, rr, rte, rtr, _ = ref.step(acts[t])
        assert np.array_equal(o1, o2) and np.array_equal(r1, r2)
        for g, w in ((o2, ro), (r2, rr), (te2, rte), (tr2, rtr)):
            assert_bitwise(g, w)
    with pytest.raises(RuntimeError):
        v2.recv()  # nothing pending
    v2.send(acts[0])
    with pytest.raises(RuntimeError):
        v2.send(acts[0])  # double send


def test_vec_episode_infos():
    """Crashing lanes surface episode_return/length through infos, equal
    to the reference's."""
    # zero thrust -> fall (every lane has crashed by step 75)
    full = np.full((150, 8, 4), -1.0, np.float32)
    got = drive(vector.make("hover", num_envs=8, seed=1, **CPU), full)
    want = drive(jvector.make("hover", num_envs=8, seed=1), full)
    assert_traces_equal(got, want)
    seen = 0
    for infos in got[1]:
        if infos:
            assert infos["episode_length"].min() >= 1
            seen += len(infos["episode_return"])
    assert seen >= 8  # every lane crashed at least once


def test_bad_backend_rejected():
    with pytest.raises(ValueError):
        vector.make("hover", num_envs=2, backend="multiprocessing", **CPU)


def test_vecenv_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vector.make("hover", num_envs=2)


# --- gymnasium adapter -------------------------------------------------------

def gym_episode(env, seed, actions):
    """reset(seed) and step until the episode ends: the obs, rewards,
    flags and the last info of each step."""
    rows = [env.reset(seed=seed)[0]]
    for a in actions:
        obs, r, term, trunc, info = env.step(a)
        rows.append((obs, np.float32(r), term, trunc, info))
        if term or trunc:
            break
    return rows


def test_gymnasium_api_contract():
    gym = pytest.importorskip("gymnasium")
    env = emulation.DroneGymnasium(task="hover", **CPU)
    assert isinstance(env, gym.Env)
    obs, info = env.reset(seed=0)
    assert obs.shape == (13,)
    obs, r, term, trunc, info = env.step(np.zeros(4, np.float32))
    assert isinstance(r, float) and not (term or trunc)

    # an episode to its end: terminal obs + episode info, then reset
    drop = np.full((2000, 4), -1.0, np.float32)
    got = gym_episode(env, 0, drop)
    want = gym_episode(JaxGymnasium(task="hover"), 0, drop)
    assert len(got) == len(want)
    assert_bitwise(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert_bitwise(g[0], w[0])
        assert g[1:] == w[1:]
    _, _, term, trunc, info = got[-1]
    assert term or trunc
    assert info["episode"]["l"] == len(got) - 1
    with pytest.raises(RuntimeError):
        env.step(np.zeros(4))
    obs2, _ = env.reset()
    assert obs2.shape == (13,)


def test_gymnasium_midepisode_reset_starts_new_episode():
    """reset() without a seed mid-episode abandons the running episode and
    starts the next one of the lane's stream (TimeLimit-style wrappers)."""
    env = emulation.DroneGymnasium(task="hover", **CPU)
    obs0, _ = env.reset(seed=3)
    for _ in range(5):
        env.step(np.zeros(4, np.float32))
    assert int(env._state.step) == 5
    obs1, _ = env.reset()
    assert int(env._state.step) == 0
    assert int(env._state.reset_count) == 1  # next episode in the stream
    assert not np.array_equal(obs0, obs1)    # randomized fresh pose
    # episode 1 of the same lane stream, as the reference builds it
    core = drone_tpu.DroneEnv(task="hover")
    s = core.init(3, 0)
    fresh = jenv.reset_state(s.key0, s.key1, np.uint32(1), core.params,
                             core.statics)
    assert_bitwise(obs1, np.asarray(core.observe(fresh)))


def test_gymnasium_matches_internal_step():
    """The adapter's trajectory equals the internal single-lane trajectory
    (same seed, same actions), with gymnasium's terminal-obs convention the
    only divergence, and equals the reference adapter's."""
    T = 50
    acts = action_stream(T=T, seed=21)
    env = emulation.DroneGymnasium(task="hover", **CPU)
    ref = JaxGymnasium(task="hover")
    obs, _ = env.reset(seed=4)
    assert_bitwise(obs, ref.reset(seed=4)[0])

    core = tenv.DroneEnv(task="hover", **CPU)
    state = core.init(4, 0)
    assert_bitwise(obs, core.observe(state)[0].numpy())
    for t in range(T):
        gobs, gr, gterm, gtrunc, ginfo = env.step(acts[t])
        robs, rr, rterm, rtrunc, rinfo = ref.step(acts[t])
        assert_bitwise(gobs, robs)
        assert (gr, gterm, gtrunc, ginfo) == (rr, rterm, rtrunc, rinfo)
        state, out = core.step(state, acts[t])
        assert np.float32(gr) == out.reward[0].numpy()
        assert gterm == bool(out.terminated) and gtrunc == bool(out.truncated)
        if gterm or gtrunc:
            env.reset()
            ref.reset()
        # post-(auto)reset both paths continue the same episode stream
        assert_bitwise(env.env.observe(env._state)[0].numpy(),
                       out.obs[0].numpy())


def partial_actions(n, T):
    actions = np.asarray(action_stream(T=T, seed=5), np.float32).reshape(
        T, 1, 4).repeat(n, axis=1)
    # per-lane action variation so lanes are distinguishable
    for i in range(n):
        actions[:, i] += 0.01 * i
    return np.clip(actions, -1.0, 1.0)


def test_partial_batch_async_matches_sync():
    """envpool-style batch_size < num_envs: two sub-batches in flight; the
    per-lane trajectory is BITWISE the sync full-batch trajectory and the
    reference's partial-batch one."""
    n, bs, T = 8, 4, 12
    actions = partial_actions(n, T)

    sync = vector.VecDrone(n, seed=9, **CPU)
    sync.reset()
    sync_obs = [sync.step(actions[t])[0].copy() for t in range(T)]

    def run_async(av):
        av.async_reset()
        out = {t: np.zeros((n, 13), np.float32) for t in range(T)}
        sent = {0: 0, 1: 0}   # steps dispatched per sub-batch
        got = {0: 0, 1: 0}    # step results recorded per sub-batch
        while got[0] < T or got[1] < T:
            o, r, te, tr, info = av.recv()
            ids = info["env_ids"]
            sub = 0 if ids[0] == 0 else 1
            if sent[sub] > 0:
                out[sent[sub] - 1][ids] = o  # result of the last send
                got[sub] = sent[sub]
            if sent[sub] < T:
                av.send(actions[sent[sub]][ids])
                sent[sub] += 1
            else:
                av._awaiting = None  # sub finished: nothing left to send
        assert sent == {0: T, 1: T} and got == {0: T, 1: T}
        return out

    async_obs = run_async(vector.VecDrone(n, seed=9, batch_size=bs, **CPU))
    ref_obs = run_async(jvector.VecDrone(n, seed=9, batch_size=bs))
    for t in range(T):
        assert_bitwise(async_obs[t], sync_obs[t], f"t={t}")
        assert_bitwise(async_obs[t], ref_obs[t], f"t={t}")


def test_partial_batch_async_interleaves_in_flight():
    """Both sub-batches are in flight at once (queue depth 2 after
    async_reset; send/recv alternate sub ids)."""
    av = vector.VecDrone(8, seed=1, batch_size=4, **CPU)
    ref = jvector.VecDrone(8, seed=1, batch_size=4)
    av.async_reset()
    ref.async_reset()
    assert len(av._queue) == 2
    zeros = np.zeros((4, 4), np.float32)
    infos = []
    for _ in range(4):
        o, r, te, tr, inf = av.recv()
        ro, rr, rte, rtr, rinf = ref.recv()
        for g, w in ((o, ro), (r, rr), (te, rte), (tr, rtr)):
            assert_bitwise(g, w)
        assert_infos_equal(inf, rinf)
        infos.append(inf)
        av.send(zeros)
        ref.send(zeros)
    assert set(infos[0]["env_ids"]) != set(infos[1]["env_ids"])
    assert len(av._queue) == 2  # two step results pending again
    # sync API is refused in partial mode
    with pytest.raises(RuntimeError):
        av.reset()


# --- gymnasium vector adapter + PettingZoo swarm -----------------------------

def test_gymnasium_vector_adapter_sb3_style():
    """SB3-style consumption: batched spaces, vector reset/step, SAME_STEP
    autoreset with final_observation surfaced through infos; every step
    equal to the reference adapter's."""
    gym = pytest.importorskip("gymnasium")
    n = 6
    venv = emulation.DroneVectorGymnasium(n, task="hover", **CPU)
    ref = JaxVectorGymnasium(n, task="hover")
    assert isinstance(venv, gym.vector.VectorEnv)
    assert venv.observation_space.shape == (n, 13)
    assert venv.action_space.shape == (n, 4)
    obs, infos = venv.reset(seed=2)
    assert obs.shape == (n, 13)
    assert_bitwise(obs, ref.reset(seed=2)[0])

    ep_seen = 0
    full_drop = np.full((n, 4), -1.0, np.float32)
    for t in range(150):
        obs, rew, term, trunc, infos = venv.step(full_drop)
        robs, rrew, rterm, rtrunc, rinfos = ref.step(full_drop)
        for g, w in ((obs, robs), (rew, rrew), (term, rterm),
                     (trunc, rtrunc)):
            assert_bitwise(g, w)
        assert_infos_equal(infos, rinfos)
        assert obs.shape == (n, 13) and rew.shape == (n,)
        done = term | trunc
        if done.any():
            assert "final_observation" in infos and "final_obs" in infos
            np.testing.assert_array_equal(infos["_final_obs"], done)
            # terminal obs is finite where done, and differs from the
            # auto-reset obs the main return carries
            fo = infos["final_observation"]
            assert np.isfinite(fo[done]).all()
            assert not np.array_equal(fo[done], obs[done])
            ep_seen += int(done.sum())
    assert ep_seen >= n  # every drone crashed at least once
    venv.close()


def swarm_run(env, seed, steps):
    """reset(seed) and drop every live drone until the swarm is gone: each
    step's (obs, rew, term, trunc, infos) dicts, the obs as bit patterns."""
    obs, _ = env.reset(seed=seed)
    rows = [{a: bits(o).tolist() for a, o in obs.items()}]
    t = 0
    while env.agents and t < steps:
        acts = {a: np.full(4, -1.0, np.float32) for a in env.agents}
        obs, rew, term, trunc, infos = env.step(acts)
        rows.append(({a: bits(o).tolist() for a, o in obs.items()}, rew,
                     term, trunc, infos, list(env.agents)))
        t += 1
    return rows


def test_pettingzoo_swarm_parallel_contract():
    pz = pytest.importorskip("pettingzoo")
    env = multiagent.DroneSwarmParallel(n_drones=3, task="hover", **CPU)
    assert isinstance(env, pz.ParallelEnv)
    obs, infos = env.reset(seed=1)
    assert set(obs) == {"drone_0", "drone_1", "drone_2"}
    assert env.agents == env.possible_agents
    assert env.observation_space("drone_0").shape == (13,)

    rows = swarm_run(env, 1, 300)
    assert rows == swarm_run(JaxSwarm(n_drones=3, task="hover"), 1, 300)
    for obs, rew, term, trunc, infos, agents in rows[1:]:
        assert set(obs) >= set(agents)
        for a, done in term.items():
            if done or trunc[a]:
                assert a not in agents
                assert infos[a]["episode"]["l"] >= 1
    assert not env.agents  # the whole swarm eventually crashed
    # reset restores the full roster
    obs, _ = env.reset()
    assert env.agents == env.possible_agents and len(obs) == 3


def test_vector_gymnasium_unseeded_reset_advances_episodes():
    """reset() without a seed continues the RNG (the counter-RNG episode
    stream advances); re-seeding reproduces the original batch."""
    env = emulation.DroneVectorGymnasium(4, task="hover", seed=9, **CPU)
    ref = JaxVectorGymnasium(4, task="hover", seed=9)
    obs0, _ = env.reset()
    obs1, _ = env.reset()
    assert not np.array_equal(obs0, obs1)  # fresh episodes, not a replay
    assert_bitwise(obs0, ref.reset()[0])
    assert_bitwise(obs1, ref.reset()[0])
    obs2, _ = env.reset(seed=9)
    np.testing.assert_array_equal(obs2, obs0)  # seeding restores stream 0


def test_swarm_unseeded_reset_advances_episodes():
    env = multiagent.DroneSwarmParallel(n_drones=3, seed=4, **CPU)
    ref = JaxSwarm(n_drones=3, seed=4)
    stack = lambda o: np.stack([o[k] for k in sorted(o)])
    a = stack(env.reset()[0])
    b = stack(env.reset()[0])
    assert not np.array_equal(a, b)
    assert_bitwise(a, stack(ref.reset()[0]))
    assert_bitwise(b, stack(ref.reset()[0]))
    c = stack(env.reset(seed=4)[0])
    np.testing.assert_array_equal(c, a)


# --- step_terminal -------------------------------------------------------------

@pytest.mark.parametrize("task,integrator", [("hover", "euler"),
                                             ("waypoint", "rk4"),
                                             ("racing", "rk4")])
def test_step_terminal_matches_reference(task, integrator):
    """The port's batched step_terminal against the reference's, vmapped:
    state, observation, terminal observation and StepOut bitwise over 40
    steps that end episodes by crash and by a 16-step horizon."""
    n, T = 8, 40
    acts = action_stream(T=T, n=n, seed=13, scale=0.9)
    jp = jax_default_params(task, horizon=16)
    tp = default_params(task, horizon=16)
    core = drone_tpu.DroneEnv(task=task, integrator=integrator, params=jp)
    jstate = core.init_batch(7, n)
    jstep = jax.jit(jax.vmap(
        lambda s, a, p: jenv.step_terminal(s, a, p, core.statics),
        in_axes=(0, 0, None)))
    env = tenv.DroneEnv(task=task, integrator=integrator, params=tp, **CPU)
    state = env.init_batch(7, n)
    ended = 0
    for t in range(T):
        jstate, jout, jterm = jstep(jstate, acts[t], jp)
        state, out, term = tenv.step_terminal(state, torch.from_numpy(acts[t]),
                                              env.params, env.statics)
        assert_bitwise(state.fstate().numpy(), pack_fstate_batch(jstate),
                       f"state t={t}")
        assert_bitwise(term.numpy(), np.asarray(jterm), f"terminal t={t}")
        for k in ("obs", "reward", "terminated", "truncated", "ep_return",
                  "ep_length"):
            assert_bitwise(getattr(out, k).numpy(),
                           np.asarray(getattr(jout, k)), f"{k} t={t}")
        done = (out.terminated | out.truncated).numpy()
        ended += int(done.sum())
        # the terminal obs is the pre-reset one where an episode ended
        if done.any():
            assert not np.array_equal(term.numpy()[done],
                                      out.obs.numpy()[done])
    assert ended >= n


# --- the fallback classes: gymnasium and pettingzoo hidden ---------------------

_OPTIONAL = ("gymnasium", "gymnasium.spaces", "gymnasium.vector",
             "gymnasium.vector.utils", "pettingzoo")


@pytest.fixture(params=["installed", "hidden"])
def optional_packages(request, monkeypatch):
    """The adapter modules as imported with gymnasium and pettingzoo
    installed, or reloaded with both hidden (their imports then raise
    ImportError), reloaded back afterwards."""
    hidden = request.param == "hidden"
    if hidden:
        for name in _OPTIONAL:
            monkeypatch.setitem(sys.modules, name, None)
        for mod in (spaces, emulation, multiagent):
            importlib.reload(mod)
    yield hidden
    if hidden:
        monkeypatch.undo()
        for mod in (spaces, emulation, multiagent):
            importlib.reload(mod)


ADAPTER_ACTIONS = action_stream(T=30, n=4, seed=17, scale=0.9)
DROP = np.full((400, 4), -1.0, np.float32)


def venv_run(venv, acts):
    rows = [venv.reset()[0]]
    for a in acts:
        obs, rew, term, trunc, infos = venv.step(a)
        rows.append((obs, rew, term, trunc,
                     {k: np.array(x) for k, x in infos.items()}))
    return rows


@pytest.fixture(scope="module")
def reference_adapters():
    """The reference adapters' runs that the port's are held to, with
    gymnasium installed and hidden alike."""
    n = 4
    return {
        "vec": drive(jvector.make("racing", num_envs=n, integrator="rk4",
                                  seed=2), ADAPTER_ACTIONS),
        "venv": venv_run(JaxVectorGymnasium(n, task="racing",
                                            integrator="rk4", seed=2),
                         ADAPTER_ACTIONS),
        "gym": gym_episode(JaxGymnasium(task="waypoint", integrator="rk4"),
                           3, DROP),
        "swarm": swarm_run(JaxSwarm(n_drones=3), 5, 300),
    }


def test_adapters_bitwise_with_and_without_gymnasium(optional_packages,
                                                     reference_adapters):
    """Every adapter (both vecenv backends, the single and the vector
    Gymnasium env, the swarm) on the same actions as the reference,
    bitwise; hidden, they are the fallback classes."""
    hidden = optional_packages
    n = 4
    want = reference_adapters
    if hidden:
        assert emulation.DroneGymnasium.__bases__ == (object,)
        assert emulation.DroneVectorGymnasium.__bases__ == (object,)
        assert multiagent.DroneSwarmParallel.__bases__ == (object,)
        assert isinstance(spaces.action_space(), spaces.Box)
    else:
        assert emulation.DroneGymnasium.__bases__ != (object,)

    for backend in vector.BACKENDS:
        got = drive(vector.make("racing", num_envs=n, integrator="rk4",
                                backend=backend, seed=2, **CPU),
                    ADAPTER_ACTIONS)
        assert_traces_equal(got, want["vec"])

    venv = emulation.make_vector(n, task="racing", integrator="rk4", seed=2,
                                 **CPU)
    assert venv.observation_space.shape == (n, 13)
    assert venv.action_space.shape == (n, 4)
    got = venv_run(venv, ADAPTER_ACTIONS)
    assert_bitwise(got[0], want["venv"][0])
    for g, w in zip(got[1:], want["venv"][1:]):
        for a, b in zip(g[:4], w[:4]):
            assert_bitwise(a, b)
        assert_infos_equal(g[4], w[4])

    got = gym_episode(emulation.make_gymnasium("waypoint", integrator="rk4",
                                               **CPU), 3, DROP)
    assert len(got) == len(want["gym"]) > 1
    assert_bitwise(got[0], want["gym"][0])
    for g, w in zip(got[1:], want["gym"][1:]):
        assert_bitwise(g[0], w[0])
        assert g[1:] == w[1:]

    swarm = multiagent.make_swarm(3, task="hover", **CPU)
    assert swarm_run(swarm, 5, 300) == want["swarm"]
