"""Batched serving CLI over the port's ``ServeSession``: prefill a batch
of random prompts, then generate.  Runs on the card unless ``--device cpu``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --batch 8 --prompt-len 1024 --gen-len 32
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.api import ServeConfig, ServeSession


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        config = ServeConfig(arch=args.arch, smoke=args.smoke, batch=args.batch,
                             seed=args.seed, device=args.device,
                             max_len=args.prompt_len + args.gen_len)
    except ValueError as e:   # ConfigError, or get_config's unknown arch
        ap.error(str(e))

    session = ServeSession.create(config)
    cfg, dev = session.cfg, session.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                       generator=gen, device=dev)}

    _sync(dev)
    t0 = time.perf_counter()
    logits = session.prefill(prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    # decode continues from the prefilled caches (generate skips the prefill
    # when handed the prompt logits)
    t0 = time.perf_counter()
    toks = session.generate(prompts, args.gen_len, generator=gen, prompt_logits=logits)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    print(f"[serve] device={dev} generated shape={tuple(toks.shape)}")
    print(f"[serve] first sequences: {toks[:2, :8].tolist()}")
    print(json.dumps({
        "arch": cfg.name, "batch": args.batch,
        "prefill_s": round(t_prefill, 3),
        "decode_tok_per_s": round(
            args.batch * (args.gen_len - 1) / max(t_decode, 1e-9), 1),
    }))


if __name__ == "__main__":
    main()
