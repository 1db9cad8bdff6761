"""Real multi-process jax.distributed execution (SURVEY §5 distributed
communication backend; BASELINE 1->N host target).

Spawns 2 OS processes, each with 2 virtual CPU devices, coordinated by
jax.distributed over localhost; the 4-device global ShardedVecEnv batch must
equal a single-process 4-device run shard-for-shard. The env loop itself has
zero per-step collectives (lockstep envs are embarrassingly parallel), so
this validates process bring-up, global-mesh construction, cross-process
device_put, and shard addressing."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_shardedvecenv(tmp_path, nproc):
    """2 and 4 coordinated OS processes (the BASELINE 1->N host shape)."""
    port = _free_port()
    procs, outs = [], []
    for pid in range(nproc):
        out = tmp_path / f"shard_{pid}.npz"
        outs.append(out)
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)          # worker sets its own
        env["JAX_PLATFORMS"] = "cpu"
        env.update(DW_COORD=f"127.0.0.1:{port}", DW_NPROC=str(nproc),
                   DW_PID=str(pid), DW_OUT=str(out),
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "_distributed_worker.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    # global batch = concatenation of per-process shards in process order
    r = np.concatenate([np.load(o)["rewards"] for o in outs], axis=0)
    m = np.concatenate([np.load(o)["mass"] for o in outs], axis=0)
    ob = np.concatenate([np.load(o)["obs"] for o in outs], axis=0)
    assert r.shape[0] == 16 and m.shape[0] == 16

    # reference: single-process 4-device run of the same program
    from agarcl_tpu.config import EnvConfig
    from agarcl_tpu.parallel.mesh import ShardedVecEnv, make_env_mesh
    import jax
    cfg = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=80,
                    num_pellets=20, num_viruses=2, num_bots=0, mode=4)
    mesh = make_env_mesh(jax.devices()[:2 * nproc])
    env = ShardedVecEnv(cfg, 16, mesh, obs_type="ram")
    states = env.reset(3)
    acts = np.tile(np.asarray([[0.6, -0.4, 0.0]], np.float32), (16, 1, 1))
    for _ in range(3):
        states, obs, rewards, dones = env.step(states, acts)

    np.testing.assert_array_equal(m, np.asarray(states.player_mass()))
    np.testing.assert_allclose(r, np.asarray(rewards), atol=1e-5)
    np.testing.assert_allclose(ob, np.asarray(obs), atol=1e-4)
