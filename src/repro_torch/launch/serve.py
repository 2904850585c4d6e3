"""Serving launcher: the continuous-batching server over any ``--arch``
(the dense, moe, vlm (text alone), ssm, hybrid and audio families;
smoke-sized with ``--smoke``), on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --device cpu --requests 16 --slots 4

Port of the reference's ``launch/serve.py``, with its arguments.  With no
card and no ``--device cpu`` it raises; it never moves to the CPU on its
own.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs.registry import get_config
from ..core.sched import serving
from ..models import registry


def main(argv=None) -> serving.ServeStats:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--policy", default="ooo", choices=["ooo", "naive"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = registry.build(cfg, device=args.device)
    params = model.init(0)
    srv = serving.Server(model, params, n_slots=args.slots,
                         max_len=args.max_len, policy=args.policy)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(2, 8))).tolist()
        srv.submit(serving.Request(i, prompt,
                                   int(rng.integers(2, args.max_new))))
    t0 = time.perf_counter()
    stats = srv.run()
    dt = time.perf_counter() - t0
    print(f"policy={args.policy} completed={stats.completed} "
          f"steps={stats.steps} utilization={stats.utilization(args.slots):.2f} "
          f"wall={dt:.1f}s tok/s={stats.slot_busy_steps / max(dt, 1e-9):.0f} "
          f"device={model.device}")
    return stats


if __name__ == "__main__":
    main()
