"""chip_smoke.py: the parts that run without a card (its comparison, its
contract line, its refusal to run on the CPU, the compile-cache rule) and a
tiny rehearsal of each phase on the CPU. The full comparisons run on the
card with `python chip_smoke.py`."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from agarcl_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    return {"alive": np.array([True, False, True]),
            "key": np.array([[3, -1], [7, 9]], np.int32),
            "pos": np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)}


def test_compare_catches_one_integer_element():
    ref, got = _tree(), _tree()
    got["key"][1, 0] = 8
    with pytest.raises(AssertionError, match=r"\['key'\].*1 of 4"):
        cs.compare(ref, got)
    got = _tree()
    got["alive"][1] = True
    with pytest.raises(AssertionError, match="alive"):
        cs.compare(ref, got)


def test_compare_catches_float_outside_tolerance():
    ref, got = _tree(), _tree()
    got["pos"][0, 1] += 2 * cs.FLOAT_ATOL
    with pytest.raises(AssertionError, match=r"\['pos'\].*> atol"):
        cs.compare(ref, got)
    got = _tree()
    got["pos"][1, 1] = np.nan
    with pytest.raises(AssertionError, match="non-finite"):
        cs.compare(ref, got)


def test_compare_accepts_within_tolerance_and_reports_worst():
    ref, got = _tree(), _tree()
    got["pos"][1, 0] += 0.5 * cs.FLOAT_ATOL
    worst = cs.compare(ref, got)
    assert 0.4 * cs.FLOAT_ATOL < worst < 0.6 * cs.FLOAT_ATOL


def _run_script(path, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, path], capture_output=True,
                          text=True, timeout=300, env=env, cwd=cwd)


def test_refuses_to_run_without_a_gpu():
    out = _run_script(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode == 1
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_result_line_has_the_contract_form():
    line = cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_make_actions_seeded_with_split_and_feed():
    a = cs.make_actions(3, 64, 2, True)
    assert a.shape == (64, 2, 3) and a.dtype == np.float32
    assert set(np.unique(a[..., 2])) == {0.0, 1.0, 2.0}
    assert np.array_equal(a, cs.make_actions(3, 64, 2, True))
    assert not cs.make_actions(3, 64, 2, False)[..., 2].any()


@pytest.fixture
def config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_cache_helper_honours_the_variable(monkeypatch, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/cache")
    assert compile_cache.enable_compile_cache() == "/somewhere/cache"
    assert config_updates == []


def test_cache_helper_uses_the_fixed_repo_path(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert config_updates == [("jax_compilation_cache_dir", path)]


def _tiny(phase, **kw):
    return dataclasses.replace(phase, num_envs=6, **kw)


def _tiny_phase(name):
    ph = cs.env_phases()[name]
    if name == "screen":
        return _tiny(ph, obs_config=dataclasses.replace(ph.obs_config,
                                                        screen_len=16))
    if name == "grid":
        return _tiny(ph, obs_config=dataclasses.replace(ph.obs_config,
                                                        grid_size=16))
    return _tiny(ph)


@pytest.mark.parametrize("name", ["duel", "grid", "screen"])
def test_env_phase_rehearsal_on_cpu(name, capsys):
    """The phase plumbing end to end at a tiny size, CPU against CPU."""
    cs.run_env_phase(_tiny_phase(name), jax.devices("cpu")[0], calls=3, k=2,
                     n_ref=3)
    out = capsys.readouterr().out
    assert f"[{name}] tick vs cpu" in out and "memory_analysis" in out
    assert "timed program's frames" in out
    assert "integer frame elements differing between the two " \
           "trajectories: 0 of" in out


def _one_env_state(ph):
    """Env 0 after reset, as a batch of one on the host, its player's tick
    count set as after a step (a zero count reads as a respawn)."""
    env = cs.VecEnv(ph.cfg, 1, obs_type=ph.obs_type,
                    obs_config=ph.obs_config, donate=False)
    states, _ = env.reset(seed=3)
    states = jax.tree.map(np.array, states)
    states.elapsed_ticks[:] = 4
    return states


def _frames(ph, states):
    """(n, F=1, A, ...) frames of a host batch, as a step returns them."""
    frame_fn, _ = cs.make_obs_fn(ph.cfg, ph.obs_type, ph.obs_config)
    return np.asarray(jax.vmap(frame_fn)(states))[:, None]


def _moved_virus(states, x, y):
    out = jax.tree.map(np.copy, states)
    out.virus_pos[0, 0] = (x, y)
    out.virus_alive[0, 0] = True
    out.virus_mass[0, 0] = 100
    return out


@pytest.mark.parametrize("shift", [2e-4, 15.0])
def test_grid_difference_is_explained_only_at_a_bin_edge(shift):
    """A virus that crosses a bin edge by a float's wobble explains the
    grid elements that changed; one that moved across bins does not."""
    ph = _tiny_phase("grid")
    states = _one_env_state(ph)
    G = ph.obs_config.grid_size
    centre, mass = cs._view(cs.env_at(states, 0), 0)
    view = min(max(2.0 * mass, 100.0), 300.0)
    edge = centre[0] + 3 * view / G             # edge between bins 10, 11
    y = centre[1] + 1.5 * view / G              # mid-bin
    ref_s = _moved_virus(states, edge - 1e-4, y)
    got_s = _moved_virus(states, edge - 1e-4 + shift, y)
    ref, got = _frames(ph, ref_s), _frames(ph, got_s)
    assert (ref != got).any()
    if shift < cs.FLOAT_ATOL:
        lines, total = cs.explain_frame_differences(ph, 1, ref_s, ref, got)
        assert total == ref.size and len(lines) == int((ref != got).sum())
        assert all("virus 0 at world distance" in ln for ln in lines)
    else:
        with pytest.raises(AssertionError, match="no entity within"):
            cs.explain_frame_differences(ph, 1, ref_s, ref, got)


@pytest.mark.parametrize("shift", [2e-4, 6.0])
def test_screen_difference_is_explained_only_at_a_rim(shift):
    """A virus whose rim crosses a pixel centre by a float's wobble
    explains the pixel that changed; one that moved by a pixel does not."""
    ph = _tiny_phase("screen")
    states = _one_env_state(ph)
    S = ph.obs_config.screen_len
    centre, mass = cs._view(cs.env_at(states, 0), 0)
    half = min(max((1000.0 + mass) * 0.1, 100.0), 900.0) * cs._TAN_HALF_FOV
    idx = cs._pixel_idx(S).astype(np.float64)
    px, py = centre[0] + idx[5] * half, centre[1] + idx[9] * half
    r = np.sqrt(100 / np.pi)
    ref_s = _moved_virus(states, px - r - 1e-4, py)
    got_s = _moved_virus(states, px - r - 1e-4 + shift, py)
    ref, got = _frames(ph, ref_s), _frames(ph, got_s)
    assert (ref != got).any()
    if shift < cs.FLOAT_ATOL:
        lines, _ = cs.explain_frame_differences(ph, 1, ref_s, ref, got)
        assert lines and all("virus 0 at world distance" in ln
                             for ln in lines)
        assert all("(0, 0, 9, 5," in ln for ln in lines)
    else:
        with pytest.raises(AssertionError, match="no entity within"):
            cs.explain_frame_differences(ph, 1, ref_s, ref, got)


def test_respawned_reads_a_live_player_at_tick_zero():
    ph = _tiny_phase("duel")
    states = _one_env_state(ph)
    assert not cs.respawned(states).any()
    states.elapsed_ticks[0, 1] = 0
    assert cs.respawned(states).tolist() == [True]
    states.cell_alive[0, 1] = False
    assert not cs.respawned(states).any()


def test_sharded_phase_rehearsal_on_cpu_mesh(capsys):
    cs.run_sharded_phase(jax.devices()[:4], envs_per_card=2, steps=2,
                         n_check=2)
    assert "devices=4" in capsys.readouterr().out


def test_ppo_phase_rehearsal_on_cpu(capsys):
    cs.run_ppo_phase(num_envs=8, iters=2, rollout=4)
    assert "params changed" in capsys.readouterr().out


@pytest.mark.gpu
def test_gpu_tick_matches_cpu(gpu_device, capsys):
    """The duel phase's comparison on the card at a small size."""
    with jax.default_device(gpu_device):
        cs.run_env_phase(dataclasses.replace(cs.env_phases()["duel"],
                                             num_envs=256),
                         jax.devices("cpu")[0])
    assert "[duel] tick vs cpu" in capsys.readouterr().out
