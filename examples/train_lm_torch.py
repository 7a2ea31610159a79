"""End-to-end training driver on the PyTorch port: train a small LM for a
few hundred steps on the synthetic pipeline, with checkpointing and
restart.  The counterpart of `examples/train_lm.py`.

Run:  PYTHONPATH=src python examples/train_lm_torch.py \
          --arch smollm-360m --steps 300 --device cpu

--reduced shrinks the model to laptop scale (default); --full trains the
published config.  --device defaults to cuda and raises where there is
no GPU.
"""
import argparse
import os
import tempfile

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import common
from repro_torch.train import loop as loop_mod
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = common.reduced(cfg, vocab=512, n_layers=max(
            2 * len(cfg.pattern), 2), d_model=128, d_ff=256)
    tcfg = step_mod.TrainConfig(
        adamw=opt.AdamWConfig(lr=args.lr, warmup_steps=20,
                              total_steps=args.steps),
        microbatches=args.microbatches)
    lcfg = loop_mod.LoopConfig(total_steps=args.steps, ckpt_every=50,
                               ckpt_dir=args.ckpt, log_every=20)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=args.batch,
                                  seq_len=args.seq))
    trainer = loop_mod.Trainer(cfg, tcfg, lcfg, data, device=args.device)
    state = trainer.init_or_restore()
    state = trainer.run(state)
    print(f"done at step {int(state['step'])}; "
          f"straggler events: {trainer.straggler_events}")


if __name__ == "__main__":
    main()
