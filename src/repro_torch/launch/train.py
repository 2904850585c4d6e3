"""Training launcher: ``--arch <id>`` + shape + fault tolerance, on one
card (or ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --steps 20 --ckpt-dir "$(mktemp -d)" --device cpu

Port of the reference's ``launch/train.py``, with its arguments.  Restart-
exact resume comes from the (seed, step)-deterministic data pipeline and
the checkpointed state: a ``--ckpt-dir`` that holds a checkpoint is
resumed from its ``LATEST``, so the default is a new directory under
``TMPDIR`` for each run.  Without a card and without ``--device cpu`` it
raises; it never moves to the CPU on its own.  More than one device, or
``--model-parallel`` above 1, needs the mesh and the sharding rules
(``launch/mesh.py``, ``sharding/rules.py``), which wait for the tail of
the port: it raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import tempfile

from ..configs.registry import get_config
from ..data import pipeline as data_lib
from ..models import registry
from ..optim.adamw import AdamWConfig
from ..runtime import train as train_rt


def main(argv=None) -> train_rt.TrainLoop:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="nothing",
                    choices=["none", "nothing", "dots"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from if it holds "
                    "one (default: a new temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--devices", type=int, default=1,
                    help="devices to train on (one: the mesh is the tail's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.devices > 1 or args.model_parallel > 1:
        raise NotImplementedError(
            "training on more than one device (a mesh, --model-parallel) "
            "needs sharding/rules.py and launch/mesh.py, the tail of the "
            "port (ROADMAP); this launcher trains on one device")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = registry.build(cfg, device=args.device)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={model.param_count()/1e6:.1f}M device={model.device}")

    tcfg = train_rt.TrainConfig(
        optimizer=AdamWConfig(lr=args.lr),
        remat_policy=args.remat,
        warmup_steps=min(20, args.steps),
        total_steps=args.steps,
        microbatches=args.microbatches,
        ckpt_every=args.ckpt_every)

    dcfg = data_lib.DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                               global_batch=args.batch)
    source = data_lib.make_source(dcfg)
    step_fn = train_rt.make_train_step(model, tcfg)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    print(f"checkpoints in {ckpt_dir}")
    loop = train_rt.TrainLoop(
        model, source, step_fn, tcfg, ckpt_dir,
        init_fn=lambda: train_rt.init_state(model, 0))
    loop.run(args.steps)
    for h in loop.history[:3] + loop.history[-3:]:
        print({k: round(v, 4) for k, v in h.items()})
    return loop


if __name__ == "__main__":
    main()
