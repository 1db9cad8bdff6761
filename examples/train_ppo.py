"""End-to-end RL training demo: PPO on the ram-obs pellet task, fully jitted.

The reference is only the environment half of an RL stack (SURVEY: "no neural
network, no learner"); this example shows the point of the rebuild — the
env batch, the policy network, and the PPO update live in ONE jit-compiled
program per iteration, so thousands of envs feed the learner with zero host
round-trips.

Run (CPU): JAX_PLATFORMS=cpu python examples/train_ppo.py --envs 64 --iters 30
Run (GPU): python examples/train_ppo.py --envs 4096 --iters 200
"""

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from agarcl_tpu import EnvConfig, env_reset, env_step
from agarcl_tpu.compile_cache import enable_compile_cache
from agarcl_tpu.obs.ram import RamObsConfig, ram_frame, ram_size


def mlp_init(key, sizes):
    params = []
    for i, (m, n) in enumerate(zip(sizes[:-1], sizes[1:])):
        k1, key = jax.random.split(key)
        params.append((jax.random.normal(k1, (m, n)) * (1.0 / np.sqrt(m)),
                       jnp.zeros((n,))))
    return params


def mlp(params, x):
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if i < len(params) - 1:
            x = jnp.tanh(x)
    return x


def make_train(cfg, ocfg, num_envs, rollout_len, lr, clip_eps=0.2,
               gamma=0.99, lam=0.95):
    obs_dim = ram_size(cfg, ocfg)
    frame_fn = functools.partial(ram_frame, cfg, ocfg)

    # fixed feature normalization: raw ram features mix world coords (~1e2)
    # and masses (~1e1-1e3); unnormalized they saturate the tanh torso
    obs_scale = 1.0 / max(cfg.arena_width, cfg.arena_height)

    def policy_out(params, obs):
        h = mlp(params["torso"], jnp.tanh(obs * obs_scale))
        mean = mlp(params["mean"], h)
        value = mlp(params["value"], h)[..., 0]
        return jnp.tanh(mean), value

    def sample_action(params, obs, key):
        mean, value = policy_out(params, obs)
        noise = 0.3 * jax.random.normal(key, mean.shape)
        act = jnp.clip(mean + noise, -1.0, 1.0)
        logp = -jnp.sum((act - mean) ** 2, axis=-1) / (2 * 0.09)
        return act, logp, value

    step_batch = jax.vmap(functools.partial(env_step, cfg, obs_fn=frame_fn))

    def rollout(params, states, obs, key):
        def body(carry, _):
            states, obs, key = carry
            key, k1 = jax.random.split(key)
            act, logp, value = sample_action(params, obs[:, 0], k1)
            actions = jnp.concatenate(
                [act, jnp.zeros((num_envs, 1))], axis=-1)[:, None, :]
            out = step_batch(states, actions)
            states, obs_f, rewards, dones = out
            nobs = obs_f[:, -1]
            return (states, nobs, key), (obs[:, 0], act, logp, value,
                                         rewards[:, 0], dones[:, 0])
        (states, obs, key), traj = jax.lax.scan(
            body, (states, obs, key), None, length=rollout_len)
        return states, obs, key, traj

    def gae(values, rewards, dones, last_value):
        def body(carry, x):
            adv_next, v_next = carry
            v, r, d = x
            nd = 1.0 - d.astype(jnp.float32)
            delta = r + gamma * v_next * nd - v
            adv = delta + gamma * lam * nd * adv_next
            return (adv, v), adv
        (_, _), advs = jax.lax.scan(
            body, (jnp.zeros_like(last_value), last_value),
            (values, rewards, dones), reverse=True)
        return advs

    opt = optax.adam(lr)

    def ppo_update(params, opt_state, traj, last_value):
        obs, act, logp_old, values, rewards, dones = traj
        advs = gae(values, rewards, dones, last_value)
        rets = advs + values
        advs = (advs - advs.mean()) / (advs.std() + 1e-8)

        def loss_fn(p):
            mean, value = policy_out(p, obs)
            logp = -jnp.sum((act - mean) ** 2, axis=-1) / (2 * 0.09)
            ratio = jnp.exp(logp - logp_old)
            pg = -jnp.minimum(
                ratio * advs,
                jnp.clip(ratio, 1 - clip_eps, 1 + clip_eps) * advs).mean()
            vloss = ((value - rets) ** 2).mean()
            return pg + 0.5 * vloss

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    @jax.jit
    def train_iter(params, opt_state, states, obs, key):
        states, obs, key, traj = rollout(params, states, obs, key)
        _, last_value = policy_out(params, obs[:, 0])
        params, opt_state, loss = ppo_update(params, opt_state, traj,
                                             last_value)
        mean_reward = traj[4].mean()
        return params, opt_state, states, obs, key, loss, mean_reward

    def init(key):
        k1, k2, k3 = jax.random.split(key, 3)
        params = dict(torso=mlp_init(k1, [obs_dim, 64, 64]),
                      mean=mlp_init(k2, [64, 2]),
                      value=mlp_init(k3, [64, 1]))
        return params, opt.init(params)

    return init, train_iter, frame_fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    enable_compile_cache()

    # dense-pellet task ("trivial" difficulty shape): strong reward signal
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=60,
                    num_pellets=200, num_viruses=0, num_bots=0, mode=3)
    ocfg = RamObsConfig()
    init, train_iter, frame_fn = make_train(cfg, ocfg, args.envs,
                                            args.rollout, args.lr)

    key = jax.random.PRNGKey(args.seed)
    params, opt_state = init(key)
    states = jax.vmap(functools.partial(env_reset, cfg))(
        jnp.arange(args.envs, dtype=jnp.uint32))
    obs = jax.vmap(frame_fn)(states)

    t0 = time.time()
    t_win = t0
    rewards_hist = []
    for it in range(args.iters):
        params, opt_state, states, obs, key, loss, mr = train_iter(
            params, opt_state, states, obs, key)
        rewards_hist.append(float(mr))
        if it % 5 == 0 or it == args.iters - 1:
            # windowed SPS: the first window is compile-dominated; later
            # windows are the steady-state training rate
            now = time.time()
            n_win = 5 if it else 1
            sps = args.envs * args.rollout * n_win / (now - t_win)
            t_win = now
            print(f"iter {it:4d}  mean_reward/step {float(mr):7.4f}  "
                  f"loss {float(loss):8.4f}  env-steps/s {sps:9.0f}",
                  flush=True)
    early = np.mean(rewards_hist[:5])
    late = np.mean(rewards_hist[-5:])
    print(f"reward/step improved: {early:.4f} -> {late:.4f}")
    return early, late


if __name__ == "__main__":
    main()
