"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``
(the port of ``repro/launch/serve.py``).

Random-inits a model of the arch and serves a batch of synthetic requests
through the prefill+decode engine. By default the model is the arch's
reduced ``smoke`` config, as in the JAX launcher; ``--full`` takes the
registry's own full config, ``--periods N`` cut to N periods of its layer
pattern. ``--kernels`` runs prefill attention through K5 and the Mamba
prefill scan through K7 (``Runtime(attn_impl="pallas", use_pallas=True)``).
Weights come from ``--seed`` and are made on the device in the parameter
dtype. It runs on ``cuda:0`` unless ``--device`` names another device::

    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --device cpu
    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --full --periods 1 --kernels

The architectures that take a frontend's embeddings (seamless-m4t's frames,
qwen2-vl's patches and their M-RoPE positions) are refused: the JAX package
drives them through their ``prefill`` and ``decode_step`` functions only,
and so does the port (``chip_smoke.py``'s phase ``archs``).

It prints a line of figures (parameters, prefill ms, decode ms a token,
tokens/s, and on the card the peak memory allocated) and the first three
requests' tokens. The JAX launcher's ``--checkpoint-dir`` waits for the
port's ``checkpoint/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.registry import all_arch_ids, get
from repro_torch.kernels.common import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import Runtime
from repro_torch.serving import Engine
from repro_torch.utils import logger


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=all_arch_ids())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda:0",
                    help="device to serve on (default cuda:0; 'cpu' runs the plain versions)")
    ap.add_argument("--full", action="store_true",
                    help="the registry's full config instead of its smoke config")
    ap.add_argument("--periods", type=int, default=None,
                    help="with --full: cut the depth to this many periods of the layer pattern")
    ap.add_argument("--kernels", action="store_true",
                    help="prefill attention through K5 and the Mamba scan through K7")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the prompts")
    return ap


def main(argv: Sequence[str] | None = None) -> Engine:
    """Serve the requests; returns the :class:`Engine` it served with, so a
    caller can go on serving the same model."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.periods is not None and not args.full:
        ap.error("--periods cuts the depth of the full config: it needs --full")
    spec = get(args.arch)
    cfg = spec.config if args.full else spec.smoke
    if cfg.input_kind != "tokens":
        how = ("models.encdec.prefill(frames, tokens) and models.encdec.decode_step"
               if cfg.n_encoder_layers else
               "models.transformer.prefill(embeds=, positions=) and decode_step(positions=)")
        raise ValueError(f"{args.arch} takes {cfg.input_kind.replace('_', ' ')}: this launcher "
                         f"serves token prompts; drive it through {how}, as the JAX package "
                         "does")
    if args.periods is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.periods * len(cfg.period))
    rt = Runtime(remat=False, moe_groups=1, mamba_chunk=16, mlstm_chunk=16,
                 **(dict(attn_impl="pallas", use_pallas=True) if args.kernels else {}))
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    model = transformer.init_lm(cfg, seed=args.seed, device=dev)
    n = transformer.n_params(model)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    logger.info("%s: %d layers, %d parameters (%d bytes, %s) made on %s in %.2f s", cfg.name,
                cfg.n_layers, n, nbytes, cfg.param_dtype, dev, time.perf_counter() - t0)

    eng = Engine(model, rt)
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(1, cfg.vocab_size, size=rng.randint(4, 16)).tolist()
               for _ in range(args.requests)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=args.max_new, temperature=args.temperature,
                       seed=args.seed)
    dt = time.perf_counter() - t0
    peak = (f", peak memory allocated {torch.cuda.max_memory_allocated(dev)} B"
            if dev.type == "cuda" else "")
    print(f"serve: {cfg.name} ({cfg.n_layers} layers, {n} parameters, {nbytes} B) on {dev}, "
          f"kernels {'on' if args.kernels else 'off'}: {args.requests} requests x "
          f"{args.max_new} new tokens in {dt * 1e3:.1f} ms: prefill {out.prefill_s * 1e3:.2f} "
          f"ms, decode {out.decode_s * 1e3 / max(out.steps - 1, 1):.2f} ms a token, "
          f"{out.tokens.size / dt:.1f} tokens/s{peak}", flush=True)
    for i in range(min(3, args.requests)):
        print(f"req{i}: {out.tokens[i].tolist()}")
    return eng


if __name__ == "__main__":
    main()
