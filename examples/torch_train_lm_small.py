"""Train a small (~25M parameter) LM with the port's training stack:
microbatch gradient accumulation, AdamW with a cosine schedule, async
checkpoints and crash-safe resume. A second invocation resumes from the
latest checkpoint.

  PYTHONPATH=src python examples/torch_train_lm_small.py [--steps 200]
      [--device cuda|cpu] [--ckpt-dir DIR] [--ckpt-every 50]
      [--log-every 20]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.transformer import init_lm
from repro_torch.train.optimizer import adamw, cosine_schedule
from repro_torch.train.train_step import init_train_state, \
    make_lm_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_lm_ckpt"))
    args = ap.parse_args(argv)

    cfg = LMConfig(name="lm-25m", n_layers=6, d_model=384, n_heads=6,
                   n_kv_heads=2, d_head=64, d_ff=1024, vocab=8192)
    print(f"params: {cfg.param_count() / 1e6:.1f}M")

    model = init_lm(cfg, seed=0, device=args.device)
    opt = adamw(cosine_schedule(3e-4, 20, args.steps))
    state = init_train_state(model, opt)
    step = make_lm_train_step(cfg, opt, num_microbatches=2)

    def batch_fn(i):
        rng = np.random.default_rng([42, i])          # step-keyed data
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 128)))
        toks = toks.to(args.device)
        return {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}

    trainer = Trainer(step, batch_fn, state,
                      TrainerConfig(total_steps=args.steps,
                                    ckpt_every=args.ckpt_every,
                                    ckpt_dir=args.ckpt_dir,
                                    log_every=args.log_every))
    trainer.maybe_restore()
    trainer.run()
    print("done; metrics tail:", trainer.metrics_log[-2:])
    return trainer


if __name__ == "__main__":
    main()
