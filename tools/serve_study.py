#!/usr/bin/env python3
"""Where the serving path's time goes, and how its two paths part, on a CUDA card.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 tools/serve_study.py [--out=PATH]

It builds the kernels and makes Jamba-v0.1 at full width, one period (the
model of ``chip_smoke.py``'s phase serve, random from seed 0), then:

1. ``divergence``: at batch 2 x 512, every layer of the period fed the
   plain path's input and run on both paths (K5 and K7, or plain attention
   and the chunked scan; ``pathcheck.prefill_layers``, in units of its
   LAYER_TOL and STATE_TOL), and the two paths run end to end, on their own
   expert choices and on the kernel path's (``pathcheck.pinned_routing``):
   each layer's output as the worst err / (2^-7 * (|want| + rms(row))), with
   the tokens the plain path routes otherwise; and the prefill logits of
   the kernel path and of the yardstick (the kernel path with PyTorch's
   SDPA in place of K5) against the plain path's, in units of 2^-4;
2. ``decode``: 8 prompts of 256 tokens, 16 greedy tokens: decode ms a
   token and prefill ms with the MoE's capacity dispatch and with
   ``moe_gather_decode``; then 5 decode steps under ``torch.profiler``:
   device time by kernel and operator, and its share of an unprofiled
   step's wall time.

It prints each line and writes everything to a JSON file (``--out``, by
default ``build/serve_study.json``), with the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SEQ = (2, 512)
DECODE = dict(batch=8, prompt=256, max_new=16, profiled_steps=5)


def sdpa(q, k, v, *, causal=True):
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), is_causal=causal,
                                          enable_gqa=True).transpose(1, 2)


@torch.no_grad()
def divergence(model, kern, plain, toks) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.models import pathcheck, transformer
    from repro_torch.models.pathcheck import RoutingLog, pinned_routing
    from repro_torch.models.pathcheck import row_scaled_ratio as ratio

    pos = torch.arange(toks.shape[1], device=toks.device)[None].expand(toks.shape)
    period = list(model.periods[0].items())
    out = {"same_input": pathcheck.prefill_layers(model, kern, plain, toks)[0], "chained": []}
    for row in out["same_input"]:
        print(f"same input (units of LAYER_TOL, STATE_TOL): {row}")

    def chain(rt, log=None):
        xs, x = [], transformer._embed_in(model, toks)
        ctx = pinned_routing(log) if log is not None else torch.no_grad()
        with ctx:
            for _, block in period:
                x, _, _ = block(x, rt, pos)
                xs.append(x)
        return xs

    routes = RoutingLog()
    x_k = chain(kern, routes)
    x_free = chain(plain)
    pinned = routes.replayed()
    x_pin = chain(plain, pinned)
    for i, (a, b, c) in enumerate(zip(x_k, x_free, x_pin)):
        row = {"layer": i, "free": ratio(a, b, 2 ** -7), "pinned": ratio(a, c, 2 ** -7)}
        out["chained"].append(row)
        print(f"end to end to layer {i}: {row}")
    out["moved"] = [pinned.moved, pinned.tokens]
    print(f"tokens the plain path routes otherwise: {pinned.moved} of {pinned.tokens}")

    lg_k, _ = transformer.prefill(model, kern, tokens=toks)
    with pinned_routing(routes.replayed()):
        lg_p, _ = transformer.prefill(model, plain, tokens=toks)
    real = ops.flash_attention
    ops.flash_attention = sdpa
    try:
        with pinned_routing(routes.replayed()):
            lg_s, _ = transformer.prefill(model, kern, tokens=toks)
    finally:
        ops.flash_attention = real
    out["logits_2^-4"] = {"kernel": ratio(lg_k, lg_p, 2 ** -4),
                          "sdpa_yardstick": ratio(lg_s, lg_p, 2 ** -4),
                          "kernel_vs_sdpa": ratio(lg_k, lg_s, 2 ** -4)}
    print(f"prefill logits against the plain path's, units of 2^-4: {out['logits_2^-4']}")
    return out


@torch.no_grad()
def decode(model, kern, rng) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer
    from repro_torch.serving import Engine

    dev = model.embed.device
    b, n, new = DECODE["batch"], DECODE["prompt"], DECODE["max_new"]
    prompts = [rng.randint(1, model.cfg.vocab_size, n).tolist() for _ in range(b)]
    eng = Engine(model, kern)
    eng.generate(prompts, max_new=4)                      # warm-up
    out = {}
    for gather in (False, True):
        eng.rt = dataclasses.replace(kern, moe_gather_decode=gather)
        res = eng.generate(prompts, max_new=new)
        out[f"moe_gather_decode={gather}"] = {
            "decode_ms_a_token": res.decode_s * 1e3 / (res.steps - 1),
            "prefill_ms": res.prefill_s * 1e3}
        print(f"moe_gather_decode={gather}: {out[f'moe_gather_decode={gather}']}")
    logits, cache = transformer.prefill(model, kern, tokens=torch.tensor(prompts, device=dev))
    cache = transformer.pad_cache(cache, model.cfg, n + 16)
    tok = logits.argmax(-1)[:, None]
    steps = DECODE["profiled_steps"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = transformer.decode_step(model, cache, tok, n + i, kern)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # the kernels' own events (an ATen op's entry repeats its kernels' time)
    kernels = sorted(((e.key, getattr(e, "self_device_time_total", 0.0), e.count)
                      for e in events if not e.key.startswith("aten::")
                      and getattr(e, "self_device_time_total", 0.0) > 0), key=lambda r: -r[1])
    device_us = sum(t for _, t, _ in kernels)
    ops_us = sorted(((e.key, getattr(e, "device_time_total", 0.0), e.count) for e in events
                     if e.key.startswith("aten::")), key=lambda r: -r[1])[:8]
    step_ms = out["moe_gather_decode=False"]["decode_ms_a_token"]
    out["profile"] = {"steps": steps, "wall_us_profiled": wall_us, "device_us": device_us,
                      "device_share_of_unprofiled_step": device_us / steps / 1e3 / step_ms,
                      "kernels": [{"name": k, "device_us": t, "calls": c}
                                  for k, t, c in kernels[:12]],
                      "ops": [{"name": k, "device_us": t, "calls": c} for k, t, c in ops_us]}
    print(f"{steps} decode steps: device {device_us:.0f} us ({device_us / steps / 1e3:.3f} ms "
          f"a step, {out['profile']['device_share_of_unprofiled_step']:.1%} of an unprofiled "
          f"step's {step_ms:.3f} ms); wall under the profiler {wall_us:.0f} us")
    for k, t, c in kernels[:12]:
        print(f"  kernel {t:10.1f} us  {c:5d} calls  {k[:90]}")
    for k, t, c in ops_us:
        print(f"  op     {t:10.1f} us  {c:5d} calls  {k}")
    return out


def main() -> int:
    out_path = Path(next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--out=")),
                         ROOT / "build" / "serve_study.json"))
    if not torch.cuda.is_available():
        print("serve_study: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.registry import get
    from repro_torch.kernels import _build
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime

    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    _build.build()
    full = get("jamba-v0.1-52b").config
    model = transformer.init_lm(dataclasses.replace(full, n_layers=len(full.period)), seed=0,
                                device=dev)
    kern = Runtime(remat=False, moe_groups=1, mamba_chunk=16, mlstm_chunk=16,
                   attn_impl="pallas", use_pallas=True)
    plain = dataclasses.replace(kern, attn_impl="plain", use_pallas=False)
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(1, full.vocab_size, SEQ)).to(dev)
    result = {"card": card, "divergence": divergence(model, kern, plain, toks),
              "decode": decode(model, kern, rng)}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
