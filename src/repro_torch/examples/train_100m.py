"""End-to-end training example: a ~100M-parameter dense LM on synthetic
data, with checkpoint/restart and the straggler watchdog (the full
runtime stack), on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 8 \
        --tiny --device cpu

Port of the reference's ``examples/train_100m.py``, with its
configurations.
"""
import argparse
import math
import tempfile

from ..configs.base import ArchConfig
from ..data import pipeline as data_lib
from ..models import registry
from ..optim.adamw import AdamWConfig
from ..runtime import train as train_rt

CFG_100M = ArchConfig(                     # ≈ 110M params (gpt2-medium-ish)
    name="lm-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=2048, vocab=32000,
)
CFG_TINY = CFG_100M.smoke()


def main(argv=None) -> train_rt.TrainLoop:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = CFG_TINY if args.tiny else CFG_100M
    model = registry.build(cfg, device=args.device)
    print(f"arch={cfg.name} params={model.param_count()/1e6:.1f}M "
          f"device={model.device}")

    dcfg = data_lib.DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                               global_batch=args.batch)
    source = data_lib.make_source(dcfg)
    tcfg = train_rt.TrainConfig(
        optimizer=AdamWConfig(lr=3e-4),
        warmup_steps=max(2, args.steps // 10), total_steps=args.steps,
        ckpt_every=max(args.steps // 4, 1))
    step_fn = train_rt.make_train_step(model, tcfg)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train100m_")
    loop = train_rt.TrainLoop(
        model, source, step_fn, tcfg, ckpt_dir,
        init_fn=lambda: train_rt.init_state(model, 0))
    loop.run(args.steps)
    first, last = loop.history[0]["loss"], loop.history[-1]["loss"]
    print(f"loss: step0={first:.3f} → step{args.steps - 1}={last:.3f} "
          f"(ckpts in {ckpt_dir}; stragglers flagged: {loop.stragglers})")
    if not math.isfinite(last):
        raise RuntimeError(f"the loss is not finite: {last}")
    if args.steps >= 100 and not last < first:
        # too few steps to demand a visible trend below 100
        raise RuntimeError("the loss must decrease on the synthetic stream")
    return loop


if __name__ == "__main__":
    main()
