DOC = """Serving launcher: batched generation on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --quant 8 [--reduced] [--device cuda]

--arch is one of the ten configs of `repro_torch.configs` (xlstm-1.3b,
mixtral-8x7b, arctic-480b, smollm-360m, gemma2-27b, gemma3-27b,
starcoder2-7b, recurrentgemma-2b, whisper-small, paligemma-3b) or the
port-only deepseek-v2-lite; --reduced runs a tiny config of the same
family.  An encoder-decoder
(whisper-small) encodes seeded random frame embeddings [batch,
frontend_len, d_model], standing in for its audio frontend.  --quant w
stores every projection as w-bit packed bit-planes (the CoMeFa path)
and runs it through the bit-plane CUDA kernel: at decode the weight
stream out of device memory shrinks 16/w x against bf16.  Params are
random, from a seeded generator.  --device defaults to cuda and raises
where there is no GPU; --device cpu runs the plain PyTorch versions.
"""
import argparse
import dataclasses


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

    if args.arch not in configs.NAMES:
        ap.error(f"--arch {args.arch!r}: the port runs "
                 f"{', '.join(configs.NAMES)}")
    cfg = configs.get(args.arch, quant_bits=args.quant)
    if args.reduced:
        cfg = common.reduced(cfg, vocab=512, d_model=128, d_ff=256,
                             quant_bits=args.quant)
        # the JAX configs' reduced depth; an MLA config keeps its own
        if cfg.n_layers < 2:
            cfg = dataclasses.replace(cfg, n_layers=2)
    dev = common.device(args.device)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    enc = None
    if cfg.family == "encdec":
        enc = torch.randn((args.batch, cfg.frontend_len, cfg.d_model),
                          generator=torch.Generator(device=dev).manual_seed(3),
                          device=dev, dtype=torch.float32)
    out = engine.generate(params, prompt, steps=args.steps,
                          max_len=args.prompt_len + args.steps + 1,
                          temperature=args.temperature,
                          generator=torch.Generator(device=dev).manual_seed(2),
                          enc_inputs=enc)
    print("generated token ids:")
    for row in out.tolist():
        print(" ", row)


if __name__ == "__main__":
    main()
