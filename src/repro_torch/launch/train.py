"""Masked-round training CLI over the port's ``Trainer``
(``repro.launch.train``, round mode): heterogeneous worker speeds give the
round schedule, heterogeneous per-worker token distributions give the
data, and every round is one ``Trainer.step``.  Runs on the card unless
``--device cpu``.  The async, multi-host, checkpoint and mesh modes of the
reference are not yet ported.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b --smoke \
      --rounds 50 --seq-len 64 --per-worker-batch 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.api import Trainer, TrainerConfig
from repro_torch.api.config import OPTIMIZERS
from repro_torch.core import (BACKENDS, delay_stats, make_round_schedule,
                              truncated_normal_speeds)
from repro_torch.data import make_token_sampler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config variant (CPU-scale)")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--per-worker-batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--opt", default="sgd", choices=sorted(OPTIMIZERS))
    ap.add_argument("--server-backend", default="reference", choices=list(BACKENDS),
                    help="DuDe round: reference = plain masked sweep, pallas = the "
                         "fused round kernel (K1)")
    ap.add_argument("--speed-std", type=float, default=1.0,
                    help="worker speed heterogeneity (paper std)")
    ap.add_argument("--heterogeneity", type=float, default=1.0,
                    help="data distribution skew across workers")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        config = TrainerConfig(arch=args.arch, smoke=args.smoke, optimizer=args.opt,
                               lr=args.lr, server_backend=args.server_backend,
                               seed=args.seed, device=args.device)
    except ValueError as e:   # ConfigError, or get_config's unknown arch
        ap.error(str(e))

    trainer = Trainer.create(config)
    cfg = trainer.cfg
    n = cfg.n_workers
    print(f"[train] arch={cfg.name} algo=dude mode=rounds workers={n} "
          f"device={trainer.device} server-backend={args.server_backend}")
    print(f"[train] params={trainer.param_count():,}")

    speeds = truncated_normal_speeds(n, std=args.speed_std, seed=args.seed + 1)
    sampler = make_token_sampler(n, cfg.vocab_size, args.seq_len, args.per_worker_batch,
                                 heterogeneity=args.heterogeneity, seed=args.seed)
    sch = make_round_schedule(speeds, args.rounds)
    print(f"[train] schedule: {delay_stats(sch)}")
    rng = np.random.default_rng(args.seed)

    def round_batch():
        per = [sampler(i, rng) for i in range(n)]
        return {k: np.stack([p[k] for p in per]) for k in per[0]}

    t0 = time.time()
    history = []                       # device tensors: read once per log line
    for r in range(sch.rounds):
        metrics = trainer.step(round_batch(), sch.start[r], sch.commit[r])
        history.append(metrics["loss"])
        if r % args.log_every == 0:
            print(f"[round {r:4d}] loss={float(metrics['loss']):.4f} "
                  f"({(time.time() - t0) / (r + 1):.2f}s/round)")
    losses = torch.stack(history).tolist()

    print(json.dumps({
        "arch": cfg.name, "algo": "dude", "mode": "rounds", "rounds": sch.rounds,
        "first_loss": losses[0], "last_loss": losses[-1],
        "wall_s": round(time.time() - t0, 1),
    }))


if __name__ == "__main__":
    main()
