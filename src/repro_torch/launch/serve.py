DOC = """Serving launcher: batched generation on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --quant 8 [--reduced] [--device cuda]

--quant w stores every projection as w-bit packed bit-planes (the CoMeFa
path) and runs it through the bit-plane CUDA kernel: at decode the weight
stream out of device memory shrinks 16/w x against bf16.  Params are
random, from a seeded generator.  --device defaults to cuda and raises
where there is no GPU; --device cpu runs the plain PyTorch versions.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=DOC, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--quant", type=int, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.models import common, lm
    from repro_torch.serve import engine

    cfg = configs.get(args.arch, quant_bits=args.quant)
    if args.reduced:
        cfg = common.reduced(cfg, vocab=512, d_model=128, d_ff=256,
                             n_layers=max(len(cfg.pattern), 2),
                             quant_bits=args.quant)
    dev = common.device(args.device)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    out = engine.generate(params, prompt, steps=args.steps,
                          max_len=args.prompt_len + args.steps + 1,
                          temperature=args.temperature,
                          generator=torch.Generator(device=dev).manual_seed(2))
    print("generated token ids:")
    for row in out.tolist():
        print(" ", row)


if __name__ == "__main__":
    main()
