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
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 1
    from repro_torch.api import ServeConfig, ServeSession
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

    meta = {
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:76"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:66"),
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
