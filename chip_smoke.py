#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one H100 visible:

    python3 chip_smoke.py

Phases, each of which raises (and so exits nonzero) on failure:
  1. Device: the card's name and power limit, as nvidia-smi reports them.
  2. Build: compiles the CUDA C++ kernels in src/repro_torch/csrc with nvcc.
  3. K2 (flash_attention) against its plain PyTorch version on the card,
     at the serving shape and over GQA/MQA/ragged/window/head-dim cases.
  4. K5 (flash_decode) against its plain version at the serving shape for
     several lengths, with and without a window, and over head-dim cases.
  5. Serving: ServeSession on qwen2-0.5b at full width (24 layers, seeded
     random weights), batch 8: prefill 1024-token prompts, generate 32
     tokens.  Every attention call must be a kernel launch (24 prefill, 24 x
     31 decode), every logit finite, and a teacher-forced prefill+decode must
     agree with a longer prefill.
  6. Times (CUDA events, median of 20 after warm-up, L2 flushed and the
     host's launch latency hidden before each run): each kernel beside its
     plain version, PyTorch's
     scaled_dot_product_attention (a yardstick the port never calls) and the
     card's bound; the session's prefill and per-token decode times.
  7. Profile: the session's device kernels by time over one prefill and
     over 8 decode steps, and the device's busy share of that window.
  8. K1 (dude_round_apply) against its plain version on the card: n in
     {1, 3, 16}, ragged P (896 and 128128), f32/bf16 buffers, f32/bf16
     fresh gradients, sgd/momentum/nesterov/adamw, no/all/random masks;
     slabs bitwise, g_bar/w/slots within 1e-5.  Then one large-index case,
     n = 16, P = 2^27 + 2^20 (n * P > 2^31, ~19 GB), checked on its first
     4096 and last 2^20 columns.
  9. Training: Trainer.step on qwen2-0.5b at full width (24 layers, seeded
     random weights), 16 workers, bf16 buffers, f32 gradients, SGD lr 0.05,
     4 rounds of the truncated-normal speed schedule, per-worker batch
     2 x 512 of skewed tokens, through the pallas backend.  K1 must launch
     once per round, every loss be finite, g_bar equal the mean of
     g_workers (the DuDe invariant), and the last round's K1 outputs on the
     last 2^20 columns equal the plain version on copies of its inputs.
 10. Times at full width, while the training state lives: Trainer.step per
     round (split into the gradients and K1), a profile of one round (top
     kernels, device idle share), and K1 and its plain version on the
     training state with a fresh slab of the main path's shape.
 11. Backends agree: qwen2-0.5b at full width with 2 layers, 4 workers, f32
     buffers, AdamW, 5 rounds on the reference and the pallas backend from
     the same params and batches: first loss bitwise, later losses within
     1e-4, final w within 1e-5.  Then K1 and its plain version at n = 16,
     P = 2^26 on separate buffers.
Then one JSON line with every kernel's record, and last the device line.

TF32 is off for matmuls and cuDNN, so the f32 comparisons are in full f32.
The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Peaks of one H100 SXM (NVIDIA data sheet, dense): the bounds below.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# Teacher-forced prefill+decode against one longer prefill at full width:
# the two paths round differently (other GEMM shapes, K2 vs K5).  In bf16 the
# gap measured 0.039 on an H100 (logits up to 3.3 in magnitude); in f32 it is
# expected near 1e-5.  See PERF.md.
TEACHER_FORCED_TOL = {torch.bfloat16: 0.1, torch.float32: 1e-3}
ARCH, BATCH, PROMPT, GEN = "qwen2_0_5b", 8, 1024, 32
MAX_LEN = 1056                    # PROMPT + GEN rounded up to the decode chunk
# K1: slabs are copied or latched (bitwise); g_bar, w and the slots are f32
# arithmetic in the kernel's order, held within K1_TOL.
K1_TOL = 1e-5
K1_KINDS = {
    "sgd": ("sgd", (("lr", 0.05),)),
    "momentum": ("momentum", (("lr", 0.05), ("beta", 0.9), ("nesterov", False))),
    "nesterov": ("momentum", (("lr", 0.05), ("beta", 0.9), ("nesterov", True))),
    "adamw": ("adamw", (("lr", 1e-3), ("b1", 0.9), ("b2", 0.999), ("eps", 1e-8),
                        ("weight_decay", 0.01))),
}
TAIL = 2 ** 20                    # columns checked at the end of a large slab
BIG_N, BIG_P = 16, 2 ** 27 + TAIL  # the large-index K1 case: n * P > 2^31
DEV = "cuda"                      # the device of the training phases
# The training run of phase 9 (the quickstart's protocol at full width).
TRAIN_ROUNDS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR = 4, 512, 2, 0.05
# The DuDe invariant g_bar == mean_i g_workers[i]: g_bar sums the commits
# incrementally in f32, the mean sums the bf16 rows at once; the two orders
# differ by a few f32 roundings of values of the size of the largest mean.
INVARIANT_RTOL = 1e-5
# Phase 11: reference vs pallas backends, same params and batches.
BACKEND_ROUNDS, BACKEND_SEQ, LOSS_TOL, W_TOL = 5, 256, 1e-4, 1e-5


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, *, n: int = 20, warm: int = 3, flush: torch.Tensor | None = None) -> float:
    """Median device time of ``fn`` in ms over ``n`` runs, each between its
    own pair of CUDA events, after ``warm`` untimed runs.  ``flush`` is
    overwritten before each run so that the inputs come from HBM, not L2.
    A ~1 ms spin kernel is queued before the start event, so that the host
    has enqueued ``fn``'s launches before the device reaches them: the time
    is the device's, without the host's launch latency."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} count={torch.cuda.device_count()}")
    return smi


def phase_build(_build) -> None:
    secs = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
        log = _build.build_log.get(name, "")
        regs = [int(w.split()[0]) for w in log.split("Used ")[1:]]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
        print(f"[build] {name}: registers per kernel {regs}, spills {spills or 'none'}")
    print(f"[build] nvcc -gencode arch=compute_90a,code=sm_90a: {secs:.1f} s "
          f"({', '.join(_build.SOURCES)})")


def phase_flash_attention(ops, ref, gen) -> float:
    """K2 against its plain version; returns the max error at the serving
    shape in bf16."""
    cases = [((8, 1024, 14, 2, 64), None, dt) for dt in (torch.bfloat16, torch.float32)]
    cases += [((2, 200, 4, 2, 32), None, dt) for dt in TOL]      # GQA, ragged tail
    cases += [((1, 96, 8, 1, 16), None, dt) for dt in TOL]       # MQA
    cases += [((1, 160, 4, 2, 32), w, dt) for w in (16, 48) for dt in TOL]
    cases += [((1, 300, 8, 2, 128), w, dt) for w in (None, 100) for dt in TOL]
    serving_err = 0.0
    for (B, S, H, K, hd), window, dt in cases:
        q, k, v = (randn(gen, s, dt) for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        print(f"[K2] B={B} S={S} H={H} K={K} hd={hd} window={window} {dt}: "
              f"max_abs_err={err:.3e} tol={TOL[dt]:.0e}")
        check(err <= TOL[dt], f"K2 disagrees with its plain version: {err} > {TOL[dt]}")
        if (B, S, H, K, hd) == (8, 1024, 14, 2, 64) and dt == torch.bfloat16:
            serving_err = err
    return serving_err


def phase_flash_decode(ops, ref, gen) -> float:
    """K5 against its plain version; returns the max error at the serving
    shape in bf16."""
    shape = (8, MAX_LEN, 14, 2, 64)
    cases = [(shape, n, w, dt) for n in (1, 3, 513, MAX_LEN) for w in (None, 64)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [((2, 300, 8, 8, 16), 250, None, dt) for dt in TOL]
    cases += [((1, 200, 4, 1, 32), 130, 50, dt) for dt in TOL]
    cases += [((1, 200, 8, 2, 128), 199, 70, dt) for dt in TOL]
    serving_err = 0.0
    for (B, S, H, K, hd), length, window, dt in cases:
        q, kc, vc = (randn(gen, s, dt) for s in ((B, 1, H, hd), (B, S, K, hd), (B, S, K, hd)))
        out = ops.flash_decode(q, kc, vc, length, window=window)
        want = ref.flash_decode_ref(q, kc, vc, length, window=window)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        print(f"[K5] B={B} S={S} H={H} K={K} hd={hd} length={length} window={window} "
              f"{dt}: max_abs_err={err:.3e} tol={TOL[dt]:.0e}")
        check(err <= TOL[dt], f"K5 disagrees with its plain version: {err} > {TOL[dt]}")
        if (B, S, H, K, hd) == shape and dt == torch.bfloat16:
            serving_err = max(serving_err, err)
    return serving_err


def teacher_forced(session, tokens):
    """Last-position logits of prefill(tokens[:, :-1]) + decode(tokens[:, -1:])
    and of prefill(tokens), each on fresh caches."""
    session.reset()
    session.prefill({"tokens": tokens[:, :-1]})
    stepped = session.decode(tokens[:, -1:])
    session.reset()
    return stepped, session.prefill({"tokens": tokens})


def phase_serve(ops, ServeConfig, ServeSession, gen):
    """The port's main path: create, prefill, generate.  Returns the session,
    the prompts and the launch counts of that run."""
    t0 = time.perf_counter()
    session = ServeSession.create(ServeConfig(arch=ARCH, batch=BATCH, max_len=MAX_LEN,
                                              seed=0, device="cuda"))
    torch.cuda.synchronize()
    cfg = session.cfg
    from repro_torch.models import param_count
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd {cfg.hd}, vocab {cfg.vocab_size}, "
          f"{param_count(session.params)} params, init {time.perf_counter() - t0:.1f} s")
    prompts = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                                       device="cuda")}
    decode_logits = []
    decode = session.decode

    def recording_decode(tokens):     # keeps what each decode step returned
        lg = decode(tokens)
        decode_logits.append(lg)
        return lg

    session.decode = recording_decode
    ops.reset_launch_counts()
    logits = session.prefill(prompts)
    torch.cuda.synchronize()
    prefill_launches = (ops.flash_attention.launches, ops.flash_decode.launches)
    toks = session.generate(prompts, GEN, generator=gen, prompt_logits=logits)
    torch.cuda.synchronize()
    launches = {"flash_attention": ops.flash_attention.launches,
                "flash_decode": ops.flash_decode.launches}
    del session.decode

    L = cfg.num_layers
    print(f"[serve] launches: prefill {prefill_launches}, total {launches}")
    check(prefill_launches == (L, 0), f"prefill launches {prefill_launches} != ({L}, 0)")
    check(launches == {"flash_attention": L, "flash_decode": L * (GEN - 1)},
          f"launches {launches} != {L} K2 and {L * (GEN - 1)} K5")
    check(logits.shape == (BATCH, 1, cfg.vocab_size) and logits.dtype == torch.float32,
          f"prefill logits {tuple(logits.shape)} {logits.dtype}")
    check(len(decode_logits) == GEN - 1, f"{len(decode_logits)} decode steps")
    all_logits = torch.cat([logits] + decode_logits, dim=1)
    check(bool(torch.isfinite(all_logits).all()), "non-finite logits")
    check(toks.shape == (BATCH, GEN) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"generated tokens {tuple(toks.shape)} out of range")
    print(f"[serve] prefill {BATCH}x{PROMPT} + generate {GEN}: logits finite, "
          f"|logit| max {all_logits.abs().max().item():.3f}, tokens {tuple(toks.shape)}")

    # Teacher forcing: K5 at the last position after a K2 prefill of the
    # rest must give the logits of one K2 prefill of the whole prompt.  In
    # bf16 the two paths round differently; with random weights the top-2
    # logit margin of a row can be smaller than that rounding, so the argmax
    # is compared on every row in f32 (same weights, f32 compute and cache)
    # and, in bf16, on the rows whose margin exceeds twice the error.
    f32 = ServeSession.create(
        ServeConfig(arch=dataclasses.replace(cfg, dtype=torch.float32), batch=BATCH,
                    max_len=MAX_LEN, device="cuda"),
        params=session.params)
    for sess, tol in ((session, TEACHER_FORCED_TOL[torch.bfloat16]),
                      (f32, TEACHER_FORCED_TOL[torch.float32])):
        stepped, full = teacher_forced(sess, prompts["tokens"])
        err = (stepped - full).abs().max().item()
        top2 = full.topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).flatten()
        same = (stepped.argmax(-1) == full.argmax(-1)).flatten()
        must = margin > 2 * err if sess is session else torch.ones_like(same)
        print(f"[serve] teacher-forced {sess.cfg.dtype}: prefill({PROMPT - 1})+decode vs "
              f"prefill({PROMPT}): max_abs_err={err:.3e} tol={tol:.0e} "
              f"argmax_equal={same.tolist()} top2_margin={[round(m, 4) for m in margin.tolist()]}")
        check(err <= tol and bool(same[must].all()),
              f"teacher-forced K2/K5 logits disagree in {sess.cfg.dtype}")
    del f32
    return session, prompts, launches


def phase_times(ops, ref, gen, session, prompts):
    flush = torch.empty(256 * 2**20 // 4, device="cuda")   # 256 MB > the 50 MB L2
    out = {}

    B, S, H, K, hd = 8, PROMPT, 14, 2, 64
    q, k, v = (randn(gen, s, torch.bfloat16) for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    flops = 4 * B * H * hd * (S * (S + 1) // 2)               # causal: unmasked pairs
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())      # q, k, v read; o written
    out["flash_attention"] = dict(
        shape=[B, S, H, K, hd], dtype="bf16",
        kernel_ms=cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True), flush=flush),
        plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), flush=flush),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush=flush),
        flops=flops, bytes=nbytes)

    S = MAX_LEN
    q = randn(gen, (B, 1, H, hd), torch.bfloat16)
    kc, vc = randn(gen, (B, S, K, hd), torch.bfloat16), randn(gen, (B, S, K, hd), torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
    out["flash_decode"] = dict(
        shape=[B, S, H, K, hd], length=S, dtype="bf16",
        kernel_ms=cuda_ms(lambda: ops.flash_decode(q, kc, vc, S), flush=flush),
        plain_ms=cuda_ms(lambda: ref.flash_decode_ref(q, kc, vc, S), flush=flush),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True), flush=flush),
        flops=4 * B * H * hd * S, bytes=2 * (kc.numel() + vc.numel() + 2 * q.numel()))

    for name, r in out.items():
        t_ops, t_bytes = r["flops"] / PEAK_BF16_FLOPS * 1e3, r["bytes"] / PEAK_HBM_BYTES_PER_S * 1e3
        r["bound_ms"] = max(t_ops, t_bytes)
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        print(json.dumps({"kernel": name, **r}))

    # Whole session: prefill of 8 x 1024, then per-token decode steps.
    def prefill():
        session.reset()
        return session.prefill(prompts)

    prefill_ms = cuda_ms(prefill, n=5, warm=1)
    session.reset()
    session.prefill(prompts)
    tok = prompts["tokens"][:, -1:]
    steps = []
    for _ in range(GEN - 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        session.decode(tok)
        end.record()
        end.synchronize()
        steps.append(start.elapsed_time(end))
    decode_ms = statistics.median(steps)
    print(json.dumps({"session": ARCH, "batch": BATCH, "prompt": PROMPT,
                      "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
                      "decode_tok_per_s": BATCH * 1e3 / decode_ms}))
    return out


def phase_profile(session, prompts) -> None:
    """Where the session's device time goes: kernels by name over one
    prefill and over 8 decode steps, and the device's busy share of the
    host wall time of that window (the profiler's own host cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def prefill():
        session.reset()
        session.prefill(prompts)

    def decode8():
        for _ in range(8):
            session.decode(prompts["tokens"][:, -1:])

    for name, fn in (("prefill", prefill), ("decode_x8", decode8)):
        if fn is decode8:
            prefill()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        print(json.dumps({"profile": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                          "device_idle_share": 1 - busy_ms / wall_ms,
                          "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3]
                                          for e in top]}))


def _k1_inputs(gen, n, P, fresh_dt, buf_dt, opt, masks):
    """Random inputs of one K1 call on the card."""
    kind, hp = K1_KINDS[opt]
    cm = sm = torch.ones(n, dtype=torch.bool, device=DEV)
    if masks == "none":
        cm = sm = torch.zeros(n, dtype=torch.bool, device=DEV)
    elif masks == "random":
        cm, sm = (torch.rand(n, generator=gen, device=DEV) < 0.5 for _ in range(2))
    vec = lambda: torch.randn(P, generator=gen, device=DEV)
    slots = {"sgd": (), "momentum": (vec(),),
             "adamw": (vec(), torch.rand(P, generator=gen, device=DEV))}[kind]
    bc = (torch.tensor([1 - 0.9 ** 3, 1 - 0.999 ** 3], device=DEV)
          if kind == "adamw" else None)
    return dict(cm=cm, sm=sm, fresh=randn(gen, (n, P), fresh_dt),
                g_workers=randn(gen, (n, P), buf_dt), inflight=randn(gen, (n, P), buf_dt),
                g_bar=vec(), w=vec(), slots=slots, bias_corr=bc, kind=kind, hp=hp)


def _clone(inp):
    return {k: (v.clone() if isinstance(v, torch.Tensor)
                else tuple(x.clone() for x in v) if k == "slots" else v)
            for k, v in inp.items()}


def _k1_compare(out, want) -> tuple[bool, float]:
    """(slabs bitwise equal, max abs error of g_bar, w and the slots) of
    two K1 results ``(g_workers, inflight, g_bar, w, slots)``."""
    slabs = all(torch.equal(a, b) for a, b in zip(out[:2], want[:2]))
    vecs = [(a, b) for a, b in zip(out[2:4], want[2:4])] + list(zip(out[4], want[4]))
    err = max((a - b).abs().max().item() for a, b in vecs)
    return slabs, err


def phase_k1(ops, ref, gen) -> float:
    """K1 against its plain version over the sweep and one large-index
    case; returns the largest error of g_bar, w and the slots."""
    worst, count = 0.0, 0
    for n in (1, 3, 16):
        for P in (128 * 7, 1000 * 128 + 128):
            for buf_dt in (torch.float32, torch.bfloat16):
                for fresh_dt in (torch.float32, torch.bfloat16):
                    for opt in K1_KINDS:
                        for masks in ("none", "all", "random"):
                            inp = _k1_inputs(gen, n, P, fresh_dt, buf_dt, opt, masks)
                            want = ref.dude_round_apply_ref(**_clone(inp))
                            out = ops.dude_round_apply(**inp)
                            torch.cuda.synchronize()
                            slabs, err = _k1_compare(out, want)
                            check(slabs and err <= K1_TOL,
                                  f"K1 disagrees with its plain version: n={n} P={P} "
                                  f"buf={buf_dt} fresh={fresh_dt} {opt} masks={masks}: "
                                  f"slabs_equal={slabs} err={err}")
                            worst, count = max(worst, err), count + 1
    print(f"[K1] {count} sweep cases: slabs bitwise equal, max_abs_err={worst:.3e} "
          f"tol={K1_TOL:.0e}")

    # n * P > 2^31: 64-bit indexing.  The plain version runs on copies of the
    # first and last columns (it would need several times the slab memory).
    n, P = BIG_N, BIG_P
    inp = _k1_inputs(gen, n, P, torch.float32, torch.bfloat16, "adamw", "all")
    cols = {"head": slice(0, 4096), "tail": slice(P - TAIL, P)}
    before = {c: _cols(inp, sl) for c, sl in cols.items()}
    ops.dude_round_apply(**inp)
    torch.cuda.synchronize()
    for c, sl in cols.items():
        want = ref.dude_round_apply_ref(**before[c])
        slabs, err = _k1_compare(_k1_outputs(inp, sl), want)
        print(f"[K1] n={n} P={P} (n*P={n * P} > 2^31) {c} columns: slabs_equal={slabs} "
              f"max_abs_err={err:.3e}")
        check(slabs and err <= K1_TOL, f"K1 disagrees on the large slab ({c} columns)")
        worst = max(worst, err)
    del inp, before
    torch.cuda.empty_cache()
    return worst


def _cols(inp, sl):
    """Contiguous copies of the K1 inputs' columns ``sl``."""
    out = dict(inp)
    for k in ("fresh", "g_workers", "inflight"):
        out[k] = inp[k][:, sl].clone()
    for k in ("g_bar", "w"):
        out[k] = inp[k][sl].clone()
    out["slots"] = tuple(x[sl].clone() for x in inp["slots"])
    return out


def _k1_outputs(inp, sl):
    return (inp["g_workers"][:, sl], inp["inflight"][:, sl], inp["g_bar"][sl],
            inp["w"][sl], tuple(x[sl] for x in inp["slots"]))


def _round_batches(n, vocab, seq, rounds):
    from repro_torch.data import make_token_sampler
    sampler = make_token_sampler(n, vocab, seq, TRAIN_BATCH, heterogeneity=2.0, seed=0)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(rounds):
        per = [sampler(i, rng) for i in range(n)]
        out.append({k: np.stack([p[k] for p in per]) for k in per[0]})
    return out


def _schedule(n, rounds):
    from repro_torch.core import make_round_schedule, truncated_normal_speeds
    return make_round_schedule(truncated_normal_speeds(n, std=1.0, seed=1), rounds=rounds)


def phase_train(ops, ref, Trainer, TrainerConfig):
    """The port's training path: Trainer.step at full width.  Returns the
    trainer, the schedule, the batches, the K1 launches of the run and the
    error of the last round's K1 on its last columns."""
    from repro_torch.kernels import dude_update
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer.create(TrainerConfig(arch=ARCH, server_backend="pallas",
                                           optimizer="sgd", lr=TRAIN_LR, seed=0,
                                           device=DEV))
    cfg, n = trainer.cfg, trainer.cfg.n_workers
    sch = _schedule(n, TRAIN_ROUNDS)
    batches = _round_batches(n, cfg.vocab_size, TRAIN_SEQ, TRAIN_ROUNDS)
    st = trainer.state
    print(f"[train] {cfg.name}: {cfg.num_layers} layers, P={trainer.param_count()}, "
          f"{n} workers, buffers {st.engine.g_workers.dtype}, per-worker batch "
          f"{TRAIN_BATCH}x{TRAIN_SEQ}, sgd lr {TRAIN_LR}, "
          f"starts/commits per round {sch.start.sum(1).tolist()}/{sch.commit.sum(1).tolist()}, "
          f"init {time.perf_counter() - t0:.1f} s")

    # The last round's K1 inputs on the last TAIL columns, copied as the
    # launcher receives them (the launcher is not counted; ops counts).
    launch, seen = dude_update.launch, {}

    def capturing(cm, sm, fresh, g_workers, inflight, g_bar, w, slots, bias_corr, *,
                  kind, hp):
        sl = slice(fresh.shape[1] - TAIL, fresh.shape[1])
        seen.update(_cols(dict(cm=cm.clone(), sm=sm.clone(), fresh=fresh,
                               g_workers=g_workers, inflight=inflight, g_bar=g_bar, w=w,
                               slots=slots, bias_corr=bias_corr, kind=kind, hp=hp), sl))
        return launch(cm, sm, fresh, g_workers, inflight, g_bar, w, slots, bias_corr,
                      kind=kind, hp=hp)

    losses = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in range(TRAIN_ROUNDS):
        if r == TRAIN_ROUNDS - 1:
            dude_update.launch = capturing
        try:
            losses.append(trainer.step(batches[r], sch.start[r], sch.commit[r])["loss"])
        finally:
            dude_update.launch = launch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": ops.flash_attention.launches,
                "flash_decode": ops.flash_decode.launches,
                "dude_round_apply": ops.dude_round_apply.launches}
    losses = torch.stack(losses)
    print(f"[train] {TRAIN_ROUNDS} rounds in {wall:.2f} s, losses {losses.tolist()}, "
          f"launches {launches}, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == {"flash_attention": 0, "flash_decode": 0,
                       "dude_round_apply": TRAIN_ROUNDS},
          f"launches {launches}: K1 must launch once per round and nothing else")
    check(bool(torch.isfinite(losses).all()), "non-finite training loss")

    st = trainer.state
    P = trainer.engine.P
    sl = slice(P - TAIL, P)
    slabs, err = _k1_compare(_k1_outputs(dict(
        g_workers=st.engine.g_workers, inflight=st.engine.inflight, g_bar=st.engine.g_bar,
        w=st.params, slots=()), sl), ref.dude_round_apply_ref(**seen))
    print(f"[train] last round's K1 on columns [{P - TAIL}, {P}) against its plain "
          f"version: slabs_equal={slabs} max_abs_err={err:.3e} tol={K1_TOL:.0e}")
    check(slabs and err <= K1_TOL, "K1 on the training state disagrees with its plain version")

    gerr, gmax = 0.0, 0.0
    for a in range(0, P, 2 ** 24):
        mean = st.engine.g_workers[:, a:a + 2 ** 24].float().mean(dim=0)
        gerr = max(gerr, (st.engine.g_bar[a:a + 2 ** 24] - mean).abs().max().item())
        gmax = max(gmax, mean.abs().max().item())
    tol = INVARIANT_RTOL * max(1.0, gmax)
    print(f"[train] invariant g_bar == mean_i g_workers[i]: max_abs_err={gerr:.3e} "
          f"(max |mean| {gmax:.3e}) tol={tol:.1e}")
    check(gerr <= tol, f"DuDe invariant broken: {gerr} > {tol}")
    return trainer, sch, batches, launches["dude_round_apply"], err


def _k1_bytes(inp) -> int:
    """Bytes K1 must move: each input read once, each output written once
    (every row is written here: the timed masks are all set)."""
    n, P = inp["fresh"].shape
    slab = inp["g_workers"].element_size()
    reads = n * (inp["fresh"].element_size() + 2 * slab) + 4 * (2 + len(inp["slots"]))
    writes = n * 2 * slab + 4 * (2 + len(inp["slots"]))
    return P * (reads + writes)


def _k1_times(ops, ref, inp) -> dict:
    nbytes = _k1_bytes(inp)
    r = dict(shape=list(inp["fresh"].shape), fresh=str(inp["fresh"].dtype),
             buffers=str(inp["g_workers"].dtype), kind=inp["kind"],
             kernel_ms=cuda_ms(lambda: ops.dude_round_apply(**inp), n=5, warm=1),
             plain_ms=cuda_ms(lambda: ref.dude_round_apply_ref(**inp), n=5, warm=1),
             bytes=nbytes, bound_ms=nbytes / PEAK_HBM_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None)
    r["kernel_GB_per_s"] = nbytes / r["kernel_ms"] / 1e6
    print(json.dumps({"kernel": "dude_round_apply", **r}))
    return r


def phase_train_times(ops, ref, trainer, sch, batches) -> dict:
    """Step time and profile of a full-width round, then K1 and its plain
    version on the training state (masks all set, so every stream moves)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = []
    for r in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.step(batches[r], sch.start[r], sch.commit[r])
        end.record()
        end.synchronize()
        steps.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batches[0], sch.start[0], sch.commit[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    k1_prof = sum(e.self_device_time_total for e in kernels
                  if "dude_round_apply" in e.key) / 1e3
    print(json.dumps({"profile": "train_round", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "device_idle_share": 1 - busy_ms / wall_ms, "k1_device_ms": k1_prof,
                      "kernel_launches": sum(e.count for e in kernels),
                      "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3]
                                      for e in top]}))

    st = trainer.state
    n, P = st.engine.g_workers.shape
    ones = torch.ones(n, dtype=torch.bool, device=DEV)
    inp = dict(cm=ones, sm=ones, fresh=torch.zeros((n, P), device=DEV),
               g_workers=st.engine.g_workers, inflight=st.engine.inflight,
               g_bar=st.engine.g_bar, w=st.params, slots=(), bias_corr=None,
               kind="sgd", hp=(("lr", TRAIN_LR),))
    times = _k1_times(ops, ref, inp)
    step_ms = statistics.median(steps)
    tokens = n * TRAIN_BATCH * TRAIN_SEQ
    print(json.dumps({"train": trainer.cfg.name, "workers": n, "tokens_per_round": tokens,
                      "step_ms": step_ms, "steps_ms": steps, "k1_ms": times["kernel_ms"],
                      "gradients_ms": step_ms - times["kernel_ms"],
                      "tokens_per_s": tokens * 1e3 / step_ms}))
    return times


def phase_backends(Trainer, TrainerConfig) -> None:
    """The reference and pallas backends from the same params and batches."""
    cfg = dataclasses.replace(TrainerConfig(arch=ARCH).model_config, num_layers=2,
                              n_workers=4)
    common = dict(arch=cfg, optimizer="adamw", lr=1e-3, buffer_dtype=torch.float32, seed=0,
                  device=DEV)
    a = Trainer.create(TrainerConfig(server_backend="reference", **common))
    b = Trainer.create(TrainerConfig(server_backend="pallas", **common), params=a.params())
    w0 = a.state.params.clone()
    sch = _schedule(cfg.n_workers, BACKEND_ROUNDS)
    batches = _round_batches(cfg.n_workers, cfg.vocab_size, BACKEND_SEQ, BACKEND_ROUNDS)
    la, lb = [], []
    for r in range(BACKEND_ROUNDS):
        la.append(a.step(batches[r], sch.start[r], sch.commit[r])["loss"])
        lb.append(b.step(batches[r], sch.start[r], sch.commit[r])["loss"])
    la, lb = torch.stack(la), torch.stack(lb)
    loss_err = (la - lb).abs().max().item()
    w_err = (a.state.params - b.state.params).abs().max().item()
    moved = (a.state.params - w0).abs().max().item()
    print(f"[backends] {cfg.name} 2 layers, P={a.param_count()}, 4 workers, f32 buffers, "
          f"adamw: losses reference {la.tolist()} pallas {lb.tolist()}; first bitwise "
          f"{bool(la[0] == lb[0])}, max loss diff {loss_err:.3e} (tol {LOSS_TOL:.0e}), "
          f"max |w diff| {w_err:.3e} (tol {W_TOL:.0e}), max |w step| {moved:.3e}")
    check(bool(la[0] == lb[0]), "first losses of the two backends differ")
    check(loss_err <= LOSS_TOL and w_err <= W_TOL, "the two backends disagree")
    check(moved > 0, "AdamW did not move the params")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 1
    from repro_torch.api import ServeConfig, ServeSession, Trainer, TrainerConfig
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False     # full-f32 matmuls and
    torch.backends.cudnn.allow_tf32 = False           # convolutions
    print("[setup] TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
          "torch.backends.cudnn.allow_tf32 = False")
    phase_device()
    phase_build(_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"flash_attention": phase_flash_attention(ops, ref, gen),
            "flash_decode": phase_flash_decode(ops, ref, gen)}
    session, prompts, launches = phase_serve(ops, ServeConfig, ServeSession, gen)
    times = phase_times(ops, ref, gen, session, prompts)
    phase_profile(session, prompts)
    del session
    torch.cuda.empty_cache()

    errs["dude_round_apply"] = phase_k1(ops, ref, gen)
    trainer, sch, batches, launches["dude_round_apply"], train_err = phase_train(
        ops, ref, Trainer, TrainerConfig)
    errs["dude_round_apply"] = max(errs["dude_round_apply"], train_err)
    times["dude_round_apply"] = phase_train_times(ops, ref, trainer, sch, batches)
    del trainer
    torch.cuda.empty_cache()
    phase_backends(Trainer, TrainerConfig)
    n, P = 16, 2 ** 26
    _k1_times(ops, ref, _k1_inputs(gen, n, P, torch.float32, torch.bfloat16, "sgd", "all"))

    meta = {
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:76"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:66"),
        "dude_round_apply": ("src/repro_torch/csrc/dude_update.cu",
                             "src/repro/kernels/dude_update.py:170"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": times[name]["kernel_ms"], "plain_ms": times[name]["plain_ms"],
                "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
                "library_ms": times[name]["library_ms"]}
               for name, (src, replaces) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
