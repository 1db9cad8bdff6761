"""Task suite, bench driver, and client-tool tests."""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from agarcl_tpu.tasks import load_task, task_config, write_task_configs


def test_task_configs_match_reference_schema():
    cfg1 = task_config(1)
    assert cfg1["arena_size"] == 350
    assert cfg1["num_pellets"] == 500
    assert cfg1["obs_type"] == "screen"
    assert cfg1["agent_view"] is True
    assert task_config(3)["number_steps"] == 3000
    assert task_config(7)["num_bots"] == 1
    assert task_config(10)["mode"] == 10
    with tempfile.TemporaryDirectory() as d:
        write_task_configs(d)
        files = sorted(os.listdir(d))
        assert len(files) == 10
        loaded = json.load(open(os.path.join(d, "mode_5.json")))
        assert loaded["mode"] == 5


def test_load_task_builds_env():
    env = load_task(1, obs_type="ram")
    obs, _ = env.reset(seed=0)
    obs, r, done, trunc, info = env.step(((0.5, 0.0), 0))
    assert isinstance(r, float)
    assert env.cfg.mode == 1
    assert env.number_of_steps == 500


def test_random_walk_driver_runs():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as d:
        csv_path = os.path.join(d, "r.csv")
        out = subprocess.run(
            [sys.executable, os.path.join(repo, "bench",
                                          "random_walk_example.py"),
             "--task", "1", "--episodes", "1", "--obs", "ram",
             "--max-steps", "5", "--csv", csv_path],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
            cwd=repo)
        assert out.returncode == 0, out.stderr[-2000:]
        rows = open(csv_path).read().strip().splitlines()
        assert rows[0] == "episode,reward,sps"
        assert len(rows) == 2


def test_client_ascii_headless(capsys):
    from agarcl_tpu.client import Client
    c = Client(arena_size=100, num_pellets=30, num_viruses=1, num_bots=2,
               screen=64)
    c.play_ascii(steps=3, size=20, fps=1000.0)
    out = capsys.readouterr().out
    assert "@" in out or "you" in out
    lb = c.leaderboard()
    assert lb[0][1] >= 25
    assert len(lb) == 3


def test_client_mouse_unprojection():
    """to_target matches the full inverse(perspective*lookAt) unprojection of
    renderer.hpp:62-78 (NDC at the far plane, camera z law renderer.hpp:91-93)."""
    import numpy as np
    from agarcl_tpu.client import Client
    c = Client(arena_size=100, num_pellets=20, num_viruses=0, num_bots=0,
               screen=64)
    cx, cy = np.asarray(c.state.player_centroid()[0])
    mass = float(np.asarray(c.state.player_mass())[0])
    cz = min(max(100.0 + mass / 10.0, 100.0), 900.0)
    half = np.tan(np.radians(22.5))

    # center pixel -> the centroid itself
    tx, ty = c.to_target(32.0, 32.0)
    assert abs(tx - cx) < 1e-4 and abs(ty - cy) < 1e-4
    # top-right corner -> ndc (1, 1) -> centroid + tan(22.5)*(1+z) both axes
    tx, ty = c.to_target(64.0, 0.0)
    assert abs(tx - (cx + half * (1 + cz))) < 1e-3
    assert abs(ty - (cy + half * (1 + cz))) < 1e-3
    # the stored mouse drives the *exact* target through apply_actions
    c.set_mouse(48.0, 16.0)
    want = c.to_target(48.0, 16.0)
    c.step()
    got = np.asarray(c.state.target[0])
    assert np.allclose(got, want, atol=1e-3)


def test_client_matplotlib_headless():
    """play() smoke test on the Agg backend (VERDICT item 10: the GUI path
    was never exercised)."""
    import matplotlib
    matplotlib.use("Agg", force=True)
    from agarcl_tpu.client import Client
    c = Client(arena_size=100, num_pellets=20, num_viruses=0, num_bots=2,
               screen=64)
    c.set_mouse(40.0, 20.0)
    c.play(max_fps=1000.0, max_seconds=0.3)
    # the loop stepped the sim at least once
    assert int(np.asarray(c.state.ticks)) > 0


def test_native_checkpoint_roundtrip():
    import functools
    import jax
    import jax.numpy as jnp
    from agarcl_tpu import EnvConfig, env_reset
    from agarcl_tpu.io.checkpoint import load_checkpoint, save_checkpoint

    cfg = EnvConfig(num_agents=1, arena_size=80, num_pellets=20,
                    num_viruses=1, mode=4)
    states = jax.vmap(functools.partial(env_reset, cfg))(
        jnp.arange(4, dtype=jnp.uint32))
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ckpt.npz")
        save_checkpoint(p, cfg, states)
        cfg2, restored = load_checkpoint(p)
        assert cfg2 == cfg
        assert np.array_equal(np.asarray(states.cell_pos),
                              np.asarray(restored.cell_pos))
        assert np.array_equal(np.asarray(states.virus_hits),
                              np.asarray(restored.virus_hits))
        # lossless: recombine timers preserved (JSON snapshots drop them)
        assert np.array_equal(np.asarray(states.cell_recombine_at),
                              np.asarray(restored.cell_recombine_at))
        import pytest as _pytest
        with _pytest.raises(ValueError):
            load_checkpoint(p, EnvConfig(num_agents=2))


def test_step_timer_and_device_time():
    import jax.numpy as jnp
    from agarcl_tpu.profiling import StepTimer, device_time_of
    t = StepTimer()
    t.start()
    x = jnp.ones((8,))
    for _ in range(3):
        x = x * 2.0
        t.tick(8, x)
    out = t.stop()
    assert out["env_steps"] == 24
    assert out["env_steps_per_sec"] > 0
    dt = device_time_of(lambda y: y + 1, jnp.ones((4,)), iters=3, warmup=1)
    assert dt >= 0
