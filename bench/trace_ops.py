"""Trace a few env-steps of one chip_smoke phase and list the device
operations that take the most time.

    python -m bench.trace_ops --phase grid [--steps 3] [--top 5]

It warms the phase's `VecEnv.multi_step` (k = --steps), traces one call with
`jax.profiler`, and reduces the trace: the device time of each operation
summed over its events, the operations' share of the traced window, and the
device's idle share (1 - busy / window, busy being the union of the
intervals in which an operation runs). Run it on the card; on the CPU the
trace has no device plane and the script says so.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os

import jax
import jax.numpy as jnp

import chip_smoke as cs
from agarcl_tpu.compile_cache import enable_compile_cache
from agarcl_tpu.profiling import trace
from agarcl_tpu.vec import VecEnv

# lines of a device plane that summarize rather than list operations
_SUMMARY_LINES = ("XLA Modules", "Steps", "Source")


def device_op_times(xplane_path: str):
    """({op name: summed device ns}, busy ns, window ns) over the device
    planes of one trace."""
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    totals = collections.Counter()
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = [ln for ln in plane.lines if ln.name not in _SUMMARY_LINES]
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or lines
        for line in ops:
            for ev in line.events:
                totals[ev.name] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        return totals, 0.0, 0.0
    intervals.sort()
    busy, (cur_s, cur_e) = 0.0, intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in intervals) - intervals[0][0]
    return totals, busy, window


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", default="ram",
                    choices=sorted(cs.env_phases()))
    ap.add_argument("--envs", type=int, default=0,
                    help="env count (0 = the phase's own)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--out", default="",
                    help="trace directory (default: <repo>/.traces/<phase>)")
    args = ap.parse_args()
    enable_compile_cache()

    ph = cs.env_phases()[args.phase]
    n = args.envs or ph.num_envs
    env = VecEnv(ph.cfg, n, obs_type=ph.obs_type, obs_config=ph.obs_config,
                 respawn_main_during_obs=ph.respawn_main_during_obs)
    states, _ = env.reset(seed=7)
    acts = jnp.asarray(cs.make_actions(1000, n, ph.cfg.num_agents,
                                       ph.split_feed))
    for _ in range(2):
        states, obs, rew, done = env.multi_step(states, acts, args.steps)
    jax.block_until_ready((states, obs, rew))

    out = args.out or os.path.join(cs.REPO, ".traces", args.phase)
    with trace(out):
        states, obs, rew, done = env.multi_step(states, acts, args.steps)
        jax.block_until_ready((states, obs, rew))

    paths = glob.glob(os.path.join(out, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    totals, busy, window = device_op_times(sorted(paths)[-1])
    dev = jax.devices()[0]
    print(f"[trace {args.phase}] {dev.device_kind} envs={n} "
          f"steps={args.steps} trace={out}")
    if not totals:
        print(f"[trace {args.phase}] no device plane in the trace "
              f"(platform {dev.platform}): nothing to reduce")
        return
    print(f"[trace {args.phase}] device window {window / 1e6:.3f} ms, busy "
          f"{busy / 1e6:.3f} ms, idle share {1 - busy / window:.4f}")
    for name, ns in totals.most_common(args.top):
        print(f"[trace {args.phase}]   {ns / 1e6:9.3f} ms "
              f"{ns / window:7.2%}  {name}")


if __name__ == "__main__":
    main()
