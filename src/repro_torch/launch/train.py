DOC = """Training launcher: the fault-tolerant loop, on one device or on
every rank of a process group.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 100 [--reduced] [--batch 16 --seq 128] [--device cuda]

Across processes every process runs this same command, with its own
--process-id:

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --fsdp \\
      --coordinator localhost:29500 --num-processes 2 --process-id 0

--arch is one of the ten configs of `repro_torch.configs`; --reduced
trains a tiny config of the same family.  Whisper-small's batches carry
seeded frame embeddings [batch, frontend_len, d_model] for its encoder
and PaliGemma-3B's seeded patch embeddings as its prefix, standing in
for their frontends.  --microbatches splits each batch for gradient
accumulation; --int8-v keeps AdamW's second moment in int8.  The loop
checkpoints under --ckpt and resumes from the newest valid checkpoint
there, on whatever mesh this run builds.  Params are random, from a
seeded generator.  --device defaults to cuda and raises where there is
no GPU; --device cpu trains on the CPU.  --quant (packed bit-plane
weights) cannot be trained and raises.

Distribution flags:
  --mesh {host,single,multi}  host: the running group's ranks as
      (data, model) (`launch.mesh.make_host_mesh`; one rank without
      --coordinator); single/multi: the 16x16 and 2x16x16 production
      meshes, which need a group of 256 or 512 ranks;
  --fsdp  shard params over the data axis too
      (`ShardingConfig(fsdp=True)`);
  --coordinator HOST:PORT, --num-processes N, --process-id I  start the
      process group (`torch.distributed.init_process_group` on
      tcp://HOST:PORT): NCCL with one rank a card (rank I on card I mod
      the cards here), gloo under --device cpu.
"""
import argparse
import os
import tempfile

import torch


class FrontendLM:
    """`SyntheticLM` batches plus the seeded embeddings a frontend would
    give: ``enc_inputs`` for an encoder-decoder, ``prefix_embeddings``
    for a vision prefix, f32 [batch, frontend_len, d_model], drawn from
    (seed, step) alone like the tokens."""

    def __init__(self, data, cfg, seed: int = 3):
        self.data, self.cfg, self.seed = data, cfg, seed
        self.key = "enc_inputs" if cfg.family == "encdec" else \
            "prefix_embeddings"

    def batch_at(self, step: int):
        import numpy as np
        import torch

        batch = self.data.batch_at(step)
        rng = np.random.default_rng((self.seed, step))
        emb = rng.standard_normal(
            (batch["tokens"].shape[0], self.cfg.frontend_len,
             self.cfg.d_model), dtype=np.float32)
        batch[self.key] = torch.from_numpy(emb)
        return batch


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=DOC, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--int8-v", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--quant", type=int, default=None)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0, to start a process group")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    if args.coordinator and (args.num_processes is None
                             or args.process_id is None):
        ap.error("--coordinator needs --num-processes and --process-id")

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import common
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import loop as loop_mod
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod

    if args.arch not in configs.REGISTRY:
        ap.error(f"--arch {args.arch!r}: the port runs "
                 f"{', '.join(configs.ARCHS)}")
    cfg = configs.get(args.arch, quant_bits=args.quant)
    if args.reduced:
        cfg = common.reduced(cfg, vocab=512, d_model=128, d_ff=256,
                             n_layers=max(len(cfg.pattern), 2),
                             quant_bits=args.quant)
    dev = common.device(args.device)
    tcfg = step_mod.TrainConfig(
        adamw=opt.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                              total_steps=args.steps,
                              int8_second_moment=args.int8_v),
        microbatches=args.microbatches)
    lcfg = loop_mod.LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=args.batch,
                                  seq_len=args.seq))
    if cfg.frontend_len:
        data = FrontendLM(data, cfg)
    started = not dist.is_initialized()
    try:
        if args.coordinator:
            if dev.type == "cuda":
                torch.cuda.set_device(args.process_id
                                      % torch.cuda.device_count())
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=f"tcp://{args.coordinator}",
                world_size=args.num_processes, rank=args.process_id)
        if args.mesh == "host":
            mesh = mesh_mod.make_host_mesh(args.device)
        else:
            mesh = mesh_mod.make_production_mesh(
                multi_pod=args.mesh == "multi", device=args.device)
        shd.set_mesh_axes(mesh.mesh_dim_names)
        rules = shd.ShardingConfig(fsdp=True).resolved() if args.fsdp \
            else None
        trainer = loop_mod.Trainer(cfg, tcfg, lcfg, data, mesh=mesh,
                                   rules=rules, device=args.device)
        state = trainer.init_or_restore()
        state = trainer.run(state)
        step = loop_mod.host_float(state["step"])
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"finished at step {int(step)}")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
