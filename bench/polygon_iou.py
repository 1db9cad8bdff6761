"""Quantify the circle-vs-polygon screen deviation per entity class.

The reference renders triangle-fan silhouettes (5-gon pellets, 7-gon foods,
50-gon cells, wavy 150-gon viruses — Entities.hpp:13-16,62-79,
renderables.hpp:191-200); obs/screen.py defaults to true circles and offers
ScreenObsConfig.polygon_edges=True to emulate the fans. This script measures
the per-class pixel IoU between the two modes over random states, giving the
quantified waiver SPEC.md cites for the default-circle mode.

Usage: JAX_PLATFORMS=cpu python bench/polygon_iou.py [screen_len] [episodes]
Prints one line per class plus a JSON summary.
"""

import json
import sys

sys.path.insert(0, ".")

import numpy as np

from agarcl_tpu import EnvConfig, env_reset, env_step
from agarcl_tpu.obs.screen import _class_map

CLASS_NAMES = {2: "pellet(5-gon)", 3: "food(7-gon)", 4: "main(50-gon)",
               5: "other(50-gon)", 6: "virus(wavy-150)"}


def main():
    S = int(sys.argv[1]) if len(sys.argv) > 1 else 84
    episodes = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    cfg = EnvConfig(num_agents=2, ticks_per_step=8, num_pellets=300,
                    num_viruses=12, mode=0)
    inter = {c: 0 for c in CLASS_NAMES}
    union = {c: 0 for c in CLASS_NAMES}
    rng = np.random.default_rng(7)
    for ep in range(episodes):
        state = env_reset(cfg, 1234 + ep)
        # seed some foods (normally only emitted by eject/virus pops) so
        # class 3 gets measured
        nf = min(40, state.food_pos.shape[0])
        fpos = state.food_pos.at[:nf].set(
            rng.uniform(0, cfg.arena_size, (nf, 2)).astype(np.float32))
        # pull player 1 into player 0's view so class 5 (other) is measured
        p0 = state.cell_pos[0, 0]
        state = state.replace(
            food_pos=fpos,
            food_alive=state.food_alive.at[:nf].set(True),
            cell_pos=state.cell_pos.at[1, 0].set(
                p0 + np.array([12.0, -8.0], np.float32)))
        for t in range(6):
            acts = np.zeros((cfg.num_agents, 3), np.float32)
            acts[:, :2] = np.cos([ep + t, ep * t + 1.0])
            state, _, _ = env_step(cfg, state, acts)
            circ = np.asarray(_class_map(cfg, state, S, polygon_edges=False))
            poly = np.asarray(_class_map(cfg, state, S, polygon_edges=True))
            for c in CLASS_NAMES:
                inter[c] += int(((circ == c) & (poly == c)).sum())
                union[c] += int(((circ == c) | (poly == c)).sum())
    out = {}
    for c, name in CLASS_NAMES.items():
        iou = inter[c] / union[c] if union[c] else float("nan")
        out[name] = round(iou, 4)
        print(f"class {c} {name:>16}: IoU {iou:.4f} "
              f"(union {union[c]} px over {episodes} episodes)")
    print(json.dumps({"metric": "polygon_vs_circle_iou", "screen_len": S,
                      "per_class": out}))


if __name__ == "__main__":
    main()
